// Lanczos-2 dense-grid query, forward only:
//   out[n] = sum over the 4x4x4 taps (i, j, k) of
//            (cx[i] * cy[j]) * cz[k] * table[px[i], py[j], pz[k]]
// for points (N, 3) f32 in a box and a (Gx, Gy, Gz, D) f32 table, where per
// axis the taps are floor(g) - 1 .. floor(g) + 2 of the point's grid
// coordinate g, each clamped to the table, and the coefficients
// sinc(g - p) * sinc((g - p) / 2) are taken at the clamped positions.
//
// Replaces no TPU kernel.  It is the no-grad form of
// ndjir_torch/ops/grid.py:query_voxel_lanczos, whose composite (about 650
// PyTorch launches a call) is what the proposal sampler, render_image and
// the SDF volume of an extraction run for every lanczos_voxel query that
// builds no autograd graph; the differentiated queries of the training
// render keep the composite.
//
// What bounds it on an H100: bytes.  Each point reads 64 table rows of
// D floats, along z four adjacent rows (64 contiguous bytes at D=4), plus
// its 12-byte point and its D-float output: N * (64 * 16 + 12 + 16) bytes
// at D=4, 0.04 ms at 3.35 TB/s for the sampler's 131,072 points.  The
// sampler's rays are coherent, so many rows come from L2.
//
// Design: four lanes a point, lane q the q-th tap on every axis.  Each lane
// computes its three tap positions and coefficients (six sinc), takes the
// x and y ones of the other three lanes by shuffle, and reads the 16 rows
// (i, j, its k): the four lanes of a point read each (i, j)'s 64 bytes as
// one coalesced piece, and a lane has its 16 loads in flight at once
// (float4 at D=4, one float a channel otherwise).
//
// Numerics: the composite's numbers, bitwise.  Every product and sum is
// written with the _rn intrinsics, so nvcc contracts nothing into an FMA,
// and each is taken as the composite's PyTorch kernels take it: a division
// by a Python scalar is a product with the f32 reciprocal; pi is the f32
// nearest to the Python float; sinf is the precise libdevice function that
// torch.sin calls.  The 64-term sum follows the order in which PyTorch's
// CUDA reduction sums dim 0 of the (64, N, D) products, tap t = 16i + 4j +
// k, where N*D is a multiple of 4 and at least 128: four outputs a thread,
// the 64 taps split over the block's 4 warps.  Warp k sums taps k, k+4,
// ..., as 4 accumulators over j, each ((0 + i=0) + i=1) ..., combined in j
// order; then (k0 + k2) + (k1 + k3).  Smaller or other output counts sum
// in other orders; the wrapper refuses them and query_voxel_lanczos sends
// them to the composite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 64 points a block, 4 lanes a point
constexpr unsigned kAll = 0xffffffffu;

// (float)math.pi, and the f32 reciprocals PyTorch multiplies by for
// y2 / 6.0, y2 / 20.0 and y2 / 42.0
constexpr float kPi = 3.14159274101257324f;
constexpr float kInv6 = 1.0f / 6.0f;
constexpr float kInv20 = 1.0f / 20.0f;
constexpr float kInv42 = 1.0f / 42.0f;

struct Query {
  const float* points;  // (n, 3)
  const float* table;   // (gx, gy, gz, d)
  float* out;           // (n, d)
  int64_t n;
  int g[3];
  int d;
  float lo[3], hi[3];
};

// sin(pi x) / (pi x), with the composite's Maclaurin branch for
// |pi x| < 0.1 (grid.py:_sinc)
__device__ __forceinline__ float sinc(float x) {
  const float y = __fmul_rn(x, kPi);
  if (fabsf(y) < 0.1f) {
    const float y2 = __fmul_rn(y, y);
    float t = __fsub_rn(1.0f, __fmul_rn(y2, kInv42));
    t = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(y2, kInv20), t));
    return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(y2, kInv6), t));
  }
  return __fdiv_rn(sinf(y), y);
}

// this lane's sum over its 16 taps (i, j) of one channel, as warp k of the
// reduction leaves it
__device__ __forceinline__ float lane_sum(const float (&p)[4][4]) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float a = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) a = __fadd_rn(a, p[i][j]);
    s = j == 0 ? a : __fadd_rn(s, a);
  }
  return s;
}

// the four lanes' sums combined; every lane of the point gets the result
__device__ __forceinline__ float combine_lanes(float s) {
  const float s0 = __shfl_sync(kAll, s, 0, 4);
  const float s1 = __shfl_sync(kAll, s, 1, 4);
  const float s2 = __shfl_sync(kAll, s, 2, 4);
  const float s3 = __shfl_sync(kAll, s, 3, 4);
  return __fadd_rn(__fadd_rn(s0, s2), __fadd_rn(s1, s3));
}

// one channel: the products of the weights w and the rows' values f, this
// lane's sum, the point's value from the four lanes' sums; stored by the
// lane whose flag `mine` is set
__device__ __forceinline__ void finish(const float (&w)[4][4],
                                       const float (&f)[4][4], bool mine,
                                       float* out) {
  float p[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = __fmul_rn(w[i][j], f[i][j]);
  const float r = combine_lanes(lane_sum(p));
  if (mine) *out = r;
}

__device__ __forceinline__ float channel(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    lanczos_voxel_gather_kernel(Query q) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 3;
  int64_t n = t >> 2;
  // a whole group past the end repeats the last point, for the shuffles
  const bool store = n < q.n;
  if (!store) n = q.n - 1;

  // this lane's tap on each axis: its row offset and its coefficient
  long long row[3];
  float coef[3];
  const long long stride[3] = {static_cast<long long>(q.g[1]) * q.g[2],
                               q.g[2], 1};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float g1 = static_cast<float>(q.g[ax] - 1);
    const float scale = __fdiv_rn(g1, __fsub_rn(q.hi[ax], q.lo[ax]));
    const float x = q.points[n * 3 + ax];
    const float g = __fmul_rn(__fsub_rn(x, q.lo[ax]), scale);
    // fmaxf and fminf take a NaN g to tap 0, a row inside the table; its
    // coefficient is NaN all the same
    const float p = fminf(
        fmaxf(__fadd_rn(floorf(g), static_cast<float>(lane - 1)), 0.0f), g1);
    const float r = __fsub_rn(g, p);
    coef[ax] = __fmul_rn(sinc(r), sinc(__fmul_rn(r, 0.5f)));
    row[ax] = static_cast<long long>(p) * stride[ax];
  }

  // the 16 taps (i, j) of this lane's k: weights and rows
  float w[4][4];
  long long rows[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float cx = __shfl_sync(kAll, coef[0], i, 4);
    const long long rx = __shfl_sync(kAll, row[0], i, 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float cy = __shfl_sync(kAll, coef[1], j, 4);
      const long long ry = __shfl_sync(kAll, row[1], j, 4);
      w[i][j] = __fmul_rn(__fmul_rn(cx, cy), coef[2]);
      rows[i][j] = rx + ry + row[2];
    }
  }

  float* out = q.out + n * q.d;
  float f[4][4];
  if (kVec4) {
    const float4* table = reinterpret_cast<const float4*>(q.table);
    float4 v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = __ldg(table + rows[i][j]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) f[i][j] = channel(v[i][j], c);
      finish(w, f, store && c == lane, out + c);
    }
  } else {
    for (int c = 0; c < q.d; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          f[i][j] = __ldg(q.table + rows[i][j] * q.d + c);
      finish(w, f, store && (c & 3) == lane, out + c);
    }
  }
}

}  // namespace

// points (n, 3), table (gx, gy, gz, d) and out (n, d): contiguous f32 on
// the device; lo/hi the box's corners (3 each); n * d a multiple of 4 and
// at least 128.  Launches on `stream` and returns the launch's cudaError_t
// (0 if none).
extern "C" int lanczos_voxel_gather(const float* points, const float* table,
                                    float* out, long long n, int gx, int gy,
                                    int gz, int d, const float* lo,
                                    const float* hi, void* stream) {
  if (n < 1 || gx < 1 || gy < 1 || gz < 1 || d < 1 || n * d % 4 != 0 ||
      n * d < 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Query q;
  q.points = points;
  q.table = table;
  q.out = out;
  q.n = n;
  q.g[0] = gx;
  q.g[1] = gy;
  q.g[2] = gz;
  q.d = d;
  for (int ax = 0; ax < 3; ++ax) {
    q.lo[ax] = lo[ax];
    q.hi[ax] = hi[ax];
  }
  const int64_t blocks = (4 * n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 4 && reinterpret_cast<uintptr_t>(table) % 16 == 0) {
    lanczos_voxel_gather_kernel<true>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(q);
  } else {
    lanczos_voxel_gather_kernel<false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(q);
  }
  return static_cast<int>(cudaGetLastError());
}
