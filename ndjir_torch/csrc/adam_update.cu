// Dual Adam over many f32 leaves in two launches (the optimizer of
// ndjir_torch/train/optim.py:apply_updates, nnabla's rule):
//   pass A  finite &= isfinite(g + wd*p)           over every leaf
//   pass B  if finite:  g' = g + wd*p
//                       m = b1*m + (1-b1)*g';  v = b2*v + (1-b2)*g'^2
//                       p -= lr*bias * m / (sqrt(v) + eps)
// with lr*bias the feature or the weight leaves' 0-dim device value.
//
// Replaces no TPU kernel: the JAX package leaves this update to XLA, which
// fuses it.  PyTorch runs it as about 15 in-place passes a leaf (the
// decay, the finite reduction, two masked fills, the moments, sqrt, eps,
// the division, the scale and the step), so at G=512 the 2.1 GB grid table
// and its gradient and moments go through device memory about 31 times a
// step, and the 85 small leaves cost ~1,275 launches of a few
// microseconds each.
//
// What bounds it on an H100: bytes.  Pass A reads g and p (2 floats an
// element, 1 without decay), pass B reads g, p, m and v and writes p, m
// and v (7): 9 x 4 bytes an element, 19.4 GB and 5.79 ms at 3.35 TB/s for
// the default tree at G=512 (538.3 M elements).
//
// Design: one launch a pass covers every leaf.  The leaves' pointers,
// sizes and learning-rate choice go by value in the launch's arguments
// (__grid_constant__, so a block reads them in place), and each block
// takes one chunk of kChunk elements of one leaf, found by a binary search
// over the prefix sums of the leaves' chunk counts: the 537 M-element table
// and the 1.5 M elements of the 85 small leaves share one launch.  A thread
// issues the loads of its 4 float4 (16 elements) of every operand before
// it computes; leaves whose operands are not all 16-byte aligned, and the
// last 0-3 elements of a leaf, take scalar loads.  Nothing is copied from
// the host and the schedule's scalars stay on the device, so both launches
// capture into a CUDA graph as they are.
//
// Numerics: PyTorch's CUDA kernels' numbers, bitwise.  Each op is written
// with the _rn intrinsics, so nvcc contracts nothing, and as PyTorch's
// kernel takes it (measured on the card over inputs that cancel):
// add_(b, alpha=s) is one FMA, a + s*b; addcmul_(b, b, value=s) is
// fma(s, b*b, a) with b*b rounded first; the moments' decay is a product
// with the f32 b1 (b2); sqrt, the eps add, the division, the product with
// lr*bias and the subtraction are each rounded once.  The constants are
// PyTorch's: the Python doubles 1-b1, 1-b2, wd, b1, b2 and eps rounded to
// f32 by the caller.
//
// Skip: pass B writes nothing when the flag is false.  That is bitwise
// what the PyTorch path leaves, which masks the gradient to -0.0, the
// decays to 1 and the step to +0.0: m + (-0.0) = m and v + (+0.0) = v for
// v >= 0 (both ±0 kept), and p - (+0.0) = p (±0 kept).  Pass A's flag is
// an AND, so any block order gives the same flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 128;  // leaves a launch; more are chunked
constexpr int kThreads = 256;
constexpr int kVec = 4;                       // float4 a thread a chunk
constexpr int kChunk = kThreads * kVec * 4;   // elements a block

struct Leaves {
  const float* g[kMaxLeaves];
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_block[kMaxLeaves];  // prefix sums of ceil(n / kChunk)
  unsigned char feat[kMaxLeaves];
  int count;
};

struct Consts {
  float wd, b1, b2, a1, a2, eps;  // a1 = 1 - b1, a2 = 1 - b2, as f32
  int decay;                      // wd > 0: g += wd * p
};

// The leaf of block b: the last one whose chunks start at or before b
// (a leaf of no elements starts where the next one does).
__device__ __forceinline__ int leaf_of(const Leaves& s, int b) {
  int lo = 0, hi = s.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s.first_block[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

__device__ __forceinline__ float decayed(float g, float p, const Consts& c) {
  return c.decay ? __fmaf_rn(c.wd, p, g) : g;
}

__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.402823466e38f;  // false for +-inf and NaN
}

__device__ __forceinline__ void adam(float g, float& p, float& m, float& v,
                                     const Consts& c, float lr_bias) {
  g = decayed(g, p, c);
  m = __fmaf_rn(c.a1, g, __fmul_rn(m, c.b1));
  v = __fmaf_rn(c.a2, __fmul_rn(g, g), __fmul_rn(v, c.b2));
  float s = __fsqrt_rn(v);
  s = __fadd_rn(s, c.eps);
  s = __fdiv_rn(m, s);
  s = __fmul_rn(s, lr_bias);
  p = __fsub_rn(p, s);
}

__global__ void __launch_bounds__(kThreads)
adam_finite_reduce_kernel(const __grid_constant__ Leaves s, const Consts c,
                          unsigned char* flag) {
  const int b = static_cast<int>(blockIdx.x);
  const int leaf = leaf_of(s, b);
  const long long n = s.n[leaf];
  const long long base =
      static_cast<long long>(b - s.first_block[leaf]) * kChunk;
  const long long end = min(base + kChunk, n);
  const float* g = s.g[leaf];
  const float* p = s.p[leaf];
  bool ok = true;
  long long tail = base;
  if (aligned16(g) && aligned16(p)) {
    const long long nvec = (end - base) >> 2;
    tail = base + 4 * nvec;
    float4 gv[kVec], pv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long j = static_cast<long long>(k) * kThreads + threadIdx.x;
      if (j < nvec) {
        gv[k] = __ldg(reinterpret_cast<const float4*>(g + base) + j);
        pv[k] = c.decay ? __ldg(reinterpret_cast<const float4*>(p + base) + j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long j = static_cast<long long>(k) * kThreads + threadIdx.x;
      if (j < nvec) {
        ok &= finite(decayed(gv[k].x, pv[k].x, c)) &
              finite(decayed(gv[k].y, pv[k].y, c)) &
              finite(decayed(gv[k].z, pv[k].z, c)) &
              finite(decayed(gv[k].w, pv[k].w, c));
      }
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    ok &= finite(decayed(g[i], c.decay ? p[i] : 0.f, c));
  }
  if (!__syncthreads_and(ok) && threadIdx.x == 0) *flag = 0;
}

__global__ void __launch_bounds__(kThreads)
adam_update_elementwise_kernel(const __grid_constant__ Leaves s,
                               const Consts c,
                               const unsigned char* finite_flag,
                               const float* lr_bias_feat,
                               const float* lr_bias_weight) {
  if (!*finite_flag) return;  // a skipped step: every value stays
  const int b = static_cast<int>(blockIdx.x);
  const int leaf = leaf_of(s, b);
  const long long n = s.n[leaf];
  const long long base =
      static_cast<long long>(b - s.first_block[leaf]) * kChunk;
  const long long end = min(base + kChunk, n);
  const float lr_bias = s.feat[leaf] ? *lr_bias_feat : *lr_bias_weight;
  const float* g = s.g[leaf];
  float* p = s.p[leaf];
  float* m = s.m[leaf];
  float* v = s.v[leaf];
  long long tail = base;
  if (aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v)) {
    const long long nvec = (end - base) >> 2;
    tail = base + 4 * nvec;
    const float4* g4 = reinterpret_cast<const float4*>(g + base);
    float4* p4 = reinterpret_cast<float4*>(p + base);
    float4* m4 = reinterpret_cast<float4*>(m + base);
    float4* v4 = reinterpret_cast<float4*>(v + base);
    float4 gv[kVec], pv[kVec], mv[kVec], vv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long j = static_cast<long long>(k) * kThreads + threadIdx.x;
      if (j < nvec) {
        gv[k] = __ldg(g4 + j);
        pv[k] = p4[j];
        mv[k] = m4[j];
        vv[k] = v4[j];
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long j = static_cast<long long>(k) * kThreads + threadIdx.x;
      if (j < nvec) {
        adam(gv[k].x, pv[k].x, mv[k].x, vv[k].x, c, lr_bias);
        adam(gv[k].y, pv[k].y, mv[k].y, vv[k].y, c, lr_bias);
        adam(gv[k].z, pv[k].z, mv[k].z, vv[k].z, c, lr_bias);
        adam(gv[k].w, pv[k].w, mv[k].w, vv[k].w, c, lr_bias);
        p4[j] = pv[k];
        m4[j] = mv[k];
        v4[j] = vv[k];
      }
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam(g[i], pi, mi, vi, c, lr_bias);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

// Fills the launch's leaves from the caller's arrays; returns the number
// of blocks (0: nothing to do), or -1 if the arguments are refused.
long long fill(Leaves& s, int count, const long long* g, const long long* p,
               const long long* m, const long long* v, const long long* n,
               const unsigned char* feat) {
  if (count < 1 || count > kMaxLeaves) return -1;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0) return -1;
    s.g[i] = reinterpret_cast<const float*>(g[i]);
    s.p[i] = reinterpret_cast<float*>(p[i]);
    s.m[i] = m ? reinterpret_cast<float*>(m[i]) : nullptr;
    s.v[i] = v ? reinterpret_cast<float*>(v[i]) : nullptr;
    s.n[i] = n[i];
    s.feat[i] = feat ? feat[i] : 0;
    s.first_block[i] = static_cast<int>(blocks);
    blocks += (n[i] + kChunk - 1) / kChunk;
    if (blocks > 0x7fffffff) return -1;
  }
  s.count = count;
  return blocks;
}

}  // namespace

extern "C" int adam_update_max_leaves() { return kMaxLeaves; }

// Pass A over `count` (1..kMaxLeaves) leaves: g[i] and p[i] are device
// addresses of n[i] contiguous f32 values each; clears the byte *flag
// (set by the caller) if some g + wd*p (g when decay is 0) is not finite.
// Launches on `stream` (nothing when every leaf is empty) and returns the
// launch's cudaError_t (0 if none).
extern "C" int adam_finite_reduce(int count, const long long* g,
                                  const long long* p, const long long* n,
                                  float wd, int decay, unsigned char* flag,
                                  void* stream) {
  Leaves s;
  const long long blocks = fill(s, count, g, p, nullptr, nullptr, n, nullptr);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  Consts c = {wd, 0.f, 0.f, 0.f, 0.f, 0.f, decay};
  adam_finite_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(s, c, flag);
  return static_cast<int>(cudaGetLastError());
}

// Pass B over `count` leaves: as pass A, plus the moments m[i], v[i] and
// feat[i] (1: the leaf takes *lr_bias_feat, 0: *lr_bias_weight); updates
// p, m and v in place unless the byte *finite is 0.  The constants are
// f32: wd, b1, b2, 1 - b1, 1 - b2, eps.
extern "C" int adam_update_elementwise(
    int count, const long long* g, const long long* p, const long long* m,
    const long long* v, const long long* n, const unsigned char* feat,
    float wd, int decay, float b1, float b2, float a1, float a2, float eps,
    const unsigned char* finite, const float* lr_bias_feat,
    const float* lr_bias_weight, void* stream) {
  Leaves s;
  const long long blocks = fill(s, count, g, p, m, v, n, feat);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  Consts c = {wd, b1, b2, a1, a2, eps, decay};
  adam_update_elementwise_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                   0, static_cast<cudaStream_t>(stream)>>>(
      s, c, finite, lr_bias_feat, lr_bias_weight);
  return static_cast<int>(cudaGetLastError());
}
