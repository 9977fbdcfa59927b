// Iso-surface extraction + mesh utilities (C API for ctypes).
//
// The port's own copy of the JAX package's host library
// (csrc/marching_cubes.cpp), code unchanged, so that both packages turn the
// same volume into the same vertices and triangles.  It replaces the
// reference's skimage.marching_cubes call (reference:
// python/extract_by_mc.py:37-43): the SDF volume is evaluated on the device
// in batches; this host library turns it into a vertex/triangle mesh.  It
// is a host library, not a device kernel.
//
// Method: marching tetrahedra (each cell split into 6 tets).  Chosen over
// classic marching cubes deliberately — it is table-free (no 256x16 case
// table to get wrong), topologically unambiguous (MC's face-saddle ambiguity
// needs MC33 to fix), and produces watertight meshes; the ~2x triangle count
// is irrelevant downstream (Chamfer sampling / attribute baking are
// per-area).  Vertices are welded via global-edge-key hashing so shared
// vertices are emitted once (indexed mesh, like skimage's output).
//
// Exported C API:
//   mc_run(field, gx, gy, gz, level, &verts, &tris, &nv, &nt) -> 0 on ok
//   mc_free(ptr)
//   mesh_connected_components(tris, nt, nv, labels) -> n_components
//   sample_triangles(verts, tris, nt, n, seed, out)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <functional>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct EdgeKey {
    uint64_t a, b;
    bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};
struct EdgeKeyHash {
    size_t operator()(const EdgeKey& e) const {
        uint64_t x = e.a * 0x9e3779b97f4a7c15ULL ^ (e.b + 0x7f4a7c15ULL);
        x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
        x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
        x ^= x >> 33;
        return (size_t)x;
    }
};

// The six tetrahedra of a cube around the main diagonal (0 -> 7), corners in
// (x, y, z) bit order: corner c = (c&1, (c>>1)&1, (c>>2)&1).
static const int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

}  // namespace

extern "C" {

int mc_run(const float* field, int gx, int gy, int gz, float level,
           float** out_verts, int** out_tris,
           int64_t* out_nv, int64_t* out_nt) {
    auto F = [&](int64_t x, int64_t y, int64_t z) -> float {
        return field[(x * gy + y) * gz + z];
    };
    auto gid = [&](int64_t x, int64_t y, int64_t z) -> uint64_t {
        return (uint64_t)((x * gy + y) * gz + z);
    };

    std::vector<float> verts;
    std::vector<int> tris;
    std::unordered_map<EdgeKey, int, EdgeKeyHash> edge_vertex;
    edge_vertex.reserve(1 << 20);

    // emit (or reuse) the iso-vertex on global edge (ga, gb)
    auto vert_on_edge = [&](uint64_t ga, uint64_t gb,
                            const float* pa, const float* pb,
                            float va, float vb) -> int {
        EdgeKey key = (ga < gb) ? EdgeKey{ga, gb} : EdgeKey{gb, ga};
        auto it = edge_vertex.find(key);
        if (it != edge_vertex.end()) return it->second;
        float t = (std::fabs(vb - va) > 1e-12f) ? (level - va) / (vb - va)
                                                : 0.5f;
        if (ga > gb) { /* orientation irrelevant; t computed per call order */ }
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        int idx = (int)(verts.size() / 3);
        for (int k = 0; k < 3; ++k)
            verts.push_back(pa[k] + t * (pb[k] - pa[k]));
        edge_vertex.emplace(key, idx);
        return idx;
    };

    for (int x = 0; x < gx - 1; ++x) {
        for (int y = 0; y < gy - 1; ++y) {
            for (int z = 0; z < gz - 1; ++z) {
                float cv[8];
                float cp[8][3];
                uint64_t cg[8];
                bool any_in = false, any_out = false;
                for (int c = 0; c < 8; ++c) {
                    int cx = x + (c & 1), cy = y + ((c >> 1) & 1),
                        cz = z + ((c >> 2) & 1);
                    cv[c] = F(cx, cy, cz);
                    cp[c][0] = (float)cx; cp[c][1] = (float)cy;
                    cp[c][2] = (float)cz;
                    cg[c] = gid(cx, cy, cz);
                    (cv[c] < level ? any_in : any_out) = true;
                }
                if (!any_in || !any_out) continue;

                for (int t = 0; t < 6; ++t) {
                    const int* T = kTets[t];
                    int inside = 0;
                    for (int i = 0; i < 4; ++i)
                        if (cv[T[i]] < level) inside |= (1 << i);
                    if (inside == 0 || inside == 15) continue;

                    // local corner indices split by sign
                    int in_ids[4], out_ids[4], ni = 0, no = 0;
                    for (int i = 0; i < 4; ++i) {
                        if (inside & (1 << i)) in_ids[ni++] = T[i];
                        else out_ids[no++] = T[i];
                    }
                    auto V = [&](int a, int b) {
                        return vert_on_edge(cg[a], cg[b], cp[a], cp[b],
                                            cv[a], cv[b]);
                    };
                    if (ni == 1) {          // one inside -> one triangle
                        int v0 = V(in_ids[0], out_ids[0]);
                        int v1 = V(in_ids[0], out_ids[1]);
                        int v2 = V(in_ids[0], out_ids[2]);
                        tris.push_back(v0); tris.push_back(v1); tris.push_back(v2);
                    } else if (ni == 3) {   // one outside -> one triangle
                        int v0 = V(out_ids[0], in_ids[0]);
                        int v1 = V(out_ids[0], in_ids[1]);
                        int v2 = V(out_ids[0], in_ids[2]);
                        tris.push_back(v0); tris.push_back(v2); tris.push_back(v1);
                    } else {                // two/two -> quad as 2 triangles
                        int v00 = V(in_ids[0], out_ids[0]);
                        int v01 = V(in_ids[0], out_ids[1]);
                        int v10 = V(in_ids[1], out_ids[0]);
                        int v11 = V(in_ids[1], out_ids[1]);
                        tris.push_back(v00); tris.push_back(v01); tris.push_back(v11);
                        tris.push_back(v00); tris.push_back(v11); tris.push_back(v10);
                    }
                }
            }
        }
    }

    *out_nv = (int64_t)(verts.size() / 3);
    *out_nt = (int64_t)(tris.size() / 3);
    *out_verts = (float*)std::malloc(verts.size() * sizeof(float) + 1);
    *out_tris = (int*)std::malloc(tris.size() * sizeof(int) + 1);
    if (!*out_verts || !*out_tris) return 1;
    if (!verts.empty())
        std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
    if (!tris.empty())
        std::memcpy(*out_tris, tris.data(), tris.size() * sizeof(int));
    return 0;
}

void mc_free(void* p) { std::free(p); }

// Union-find over vertices -> per-triangle component labels.
int mesh_connected_components(const int* tris, int64_t nt, int64_t nv,
                              int* tri_labels /* size nt */) {
    std::vector<int> parent(nv);
    for (int64_t i = 0; i < nv; ++i) parent[i] = (int)i;
    std::vector<int> pr(nv, 0);
    std::function<int(int)> find = [&](int a) {
        while (parent[a] != a) { parent[a] = parent[parent[a]]; a = parent[a]; }
        return a;
    };
    auto unite = [&](int a, int b) {
        a = find(a); b = find(b);
        if (a == b) return;
        if (pr[a] < pr[b]) std::swap(a, b);
        parent[b] = a;
        if (pr[a] == pr[b]) pr[a]++;
    };
    for (int64_t t = 0; t < nt; ++t) {
        unite(tris[3 * t], tris[3 * t + 1]);
        unite(tris[3 * t], tris[3 * t + 2]);
    }
    std::unordered_map<int, int> remap;
    int next = 0;
    for (int64_t t = 0; t < nt; ++t) {
        int root = find(tris[3 * t]);
        auto it = remap.find(root);
        if (it == remap.end()) { remap.emplace(root, next); tri_labels[t] = next++; }
        else tri_labels[t] = it->second;
    }
    return next;
}

// Area-weighted uniform point sampling on a triangle soup (Chamfer eval;
// the reference uses a python multiprocessing pool for this,
// evaluate_chamfer_dtumvs.py:105-106).
void sample_triangles(const float* verts, const int* tris, int64_t nt,
                      int64_t n_samples, uint64_t seed, float* out) {
    std::vector<double> cum(nt);
    double acc = 0.0;
    for (int64_t t = 0; t < nt; ++t) {
        const float* a = verts + 3 * (int64_t)tris[3 * t];
        const float* b = verts + 3 * (int64_t)tris[3 * t + 1];
        const float* c = verts + 3 * (int64_t)tris[3 * t + 2];
        double ux = b[0] - a[0], uy = b[1] - a[1], uz = b[2] - a[2];
        double vx = c[0] - a[0], vy = c[1] - a[1], vz = c[2] - a[2];
        double cx = uy * vz - uz * vy, cy = uz * vx - ux * vz,
               cz = ux * vy - uy * vx;
        acc += 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
        cum[t] = acc;
    }
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    for (int64_t i = 0; i < n_samples; ++i) {
        double r = uni(rng) * acc;
        int64_t lo = 0, hi = nt - 1;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (cum[mid] < r) lo = mid + 1; else hi = mid;
        }
        const float* a = verts + 3 * (int64_t)tris[3 * lo];
        const float* b = verts + 3 * (int64_t)tris[3 * lo + 1];
        const float* c = verts + 3 * (int64_t)tris[3 * lo + 2];
        double u = uni(rng), v = uni(rng);
        if (u + v > 1.0) { u = 1.0 - u; v = 1.0 - v; }
        for (int k = 0; k < 3; ++k)
            out[3 * i + k] = (float)(a[k] + u * (b[k] - a[k])
                                     + v * (c[k] - a[k]));
    }
}

}  // extern "C"
