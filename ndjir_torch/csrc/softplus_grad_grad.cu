// The softplus second derivative of the eikonal double backward, in one
// pass (ndjir_torch/ops/activations.py: _SoftplusGrad.backward).  For
// dg_in = gg * softplus_beta'(x), the derivative of g * softplus_beta'(x)
// in g, and dx = gg * g * softplus_beta''(x), its derivative in x:
//   dg = 0                           at x = +-0
//        gg                          where beta x > threshold
//        gg * z / (z + 1)            elsewhere, z = exp(beta x)
//   dx = ((gg g) (1 - s) s) [b < threshold] beta,  b = x beta,
//        s = sigmoid(b)
//
// Replaces no TPU kernel: XLA fuses the JAX package's double backward.
// PyTorch runs it as the first derivative's jiterator kernel for dg and
// eight launches for dx (x * beta, sigmoid, gg * g, sigmoid_backward, the
// comparison, its cast and two products), about 20 passes over a tensor of
// the layer's shape, where one pass reads gg, g and x and writes dg and dx.
// The default step runs it once per hidden layer of the geometric MLP at
// the rendered points: 7 layers of 262,144 x 256 values a step.
//
// What bounds it on an H100: bytes, 5 values an element (3 read, 2
// written): 1.34 GB and 0.40 ms at 3.35 TB/s for one f32 layer of the
// default step.  Each thread takes 16 bytes of each operand at a time (4
// f32 or 8 bf16 values), over a grid-stride loop of a few blocks an SM;
// operands not all 16-byte aligned, and the last values, take scalar loads.
// g may be the rows of a wider tensor (the cotangent of the skip
// concatenation's slice: 213 of 256 columns at the layer before it), read
// row by row with one division a vector.  When only one output is wanted
// the other is neither computed nor written, and without dx g is not read.
// Nothing is allocated here.
//
// Numerics: PyTorch's CUDA kernels' numbers, bitwise.  Every op is an f32
// op in the composite's order, written with the _rn intrinsics so that nvcc
// contracts nothing, and expf is the accurate one (no fast math), as in
// PyTorch's kernels and the jiterator's.  dg is the jiterator kernel's
// arithmetic (beta x in f32, one rounding to the dtype at the end).  For
// bf16 dx rounds to the dtype where each of the composite's ops
// writes its output (x * beta, the sigmoid, gg * g, both products), and
// where sigmoid_backward's own arithmetic rounds (1 - s, a (1 - s), then
// times s: its CUDA kernel computes in the dtype, measured on the card),
// with cvt.rn as c10's BFloat16 does on sm_80+.  The port's MLPs run in
// f32 or bf16 (models/fields.py), so there is no f16 instantiation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

// A dtype: its storage, read into f32 exactly and written from f32 rounded
// to nearest even.
struct F32 {
  using S = float;
  static __device__ __forceinline__ float get(S v) { return v; }
  static __device__ __forceinline__ S put(float v) { return v; }
};

struct BF16 {
  using S = unsigned short;
  static __device__ __forceinline__ float get(S v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ S put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// v rounded to the dtype, as an op of the composite writes it
template <typename K>
__device__ __forceinline__ float rounded(float v) {
  return K::get(K::put(v));
}

template <typename K, bool DG, bool DX>
__device__ __forceinline__ void element(typename K::S gg, typename K::S g,
                                        typename K::S x, typename K::S& dg,
                                        typename K::S& dx, float beta,
                                        float threshold) {
  const float xf = K::get(x);
  const float ggf = K::get(gg);
  if (DG) {
    if (xf == 0.0f) {
      dg = K::put(0.0f);
    } else {
      const float bx = __fmul_rn(xf, beta);
      const float z = expf(bx);
      dg = bx > threshold
               ? gg
               : K::put(__fdiv_rn(__fmul_rn(ggf, z), __fadd_rn(z, 1.0f)));
    }
  }
  if (DX) {
    const float b = rounded<K>(__fmul_rn(xf, beta));
    const float s = rounded<K>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-b))));
    const float a = rounded<K>(__fmul_rn(ggf, K::get(g)));
    const float sb = rounded<K>(
        __fmul_rn(rounded<K>(__fmul_rn(a, rounded<K>(__fsub_rn(1.0f, s)))),
                  s));
    const float below = b < threshold ? 1.0f : 0.0f;
    const float t = rounded<K>(__fmul_rn(sb, below));
    dx = K::put(__fmul_rn(t, beta));
  }
}

template <typename S>
union Pack {
  uint4 u;
  S v[sizeof(uint4) / sizeof(S)];
};

// The operands as the kernel reads them: gg, x, dg and dx hold n contiguous
// values; g holds rows of `g_cols` values, `g_ld` apart (g_ld == g_cols:
// contiguous too).
template <typename S>
struct Operands {
  const S* __restrict__ gg;
  const S* __restrict__ g;
  const S* __restrict__ x;
  S* __restrict__ dg;
  S* __restrict__ dx;
  long long n, g_cols, g_ld;
  float beta, threshold;
};

template <typename S>
__device__ __forceinline__ S g_at(const Operands<S>& o, long long i) {
  const long long r = i / o.g_cols;
  return o.g[r * o.g_ld + (i - r * o.g_cols)];
}

template <typename K, bool DG, bool DX>
__global__ void __launch_bounds__(kThreads)
    softplus_grad_grad_kernel(const Operands<typename K::S> o,
                              int vectorized) {
  using S = typename K::S;
  constexpr int V = sizeof(uint4) / sizeof(S);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool g_dense = o.g_ld == o.g_cols;
  long long tail = 0;
  if (vectorized) {
    const long long nvec = o.n / V;
    tail = nvec * V;
    for (long long i = first; i < nvec; i += stride) {
      Pack<S> a, b, c, r, t;
      a.u = __ldg(reinterpret_cast<const uint4*>(o.gg) + i);
      if (DX && g_dense) {
        b.u = __ldg(reinterpret_cast<const uint4*>(o.g) + i);
      } else if (DX) {  // g's rows: one division a vector
        long long row = (i * V) / o.g_cols, col = i * V - row * o.g_cols;
        const S* p = o.g + row * o.g_ld;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          b.v[k] = p[col];
          if (++col == o.g_cols) {
            col = 0;
            p += o.g_ld;
          }
        }
      }
      c.u = __ldg(reinterpret_cast<const uint4*>(o.x) + i);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        element<K, DG, DX>(a.v[k], DX ? b.v[k] : S(), c.v[k], r.v[k], t.v[k],
                           o.beta, o.threshold);
      }
      if (DG) reinterpret_cast<uint4*>(o.dg)[i] = r.u;
      if (DX) reinterpret_cast<uint4*>(o.dx)[i] = t.u;
    }
  }
  for (long long i = tail + first; i < o.n; i += stride) {
    S r, t;
    element<K, DG, DX>(o.gg[i], DX ? g_at(o, i) : S(), o.x[i], r, t, o.beta,
                       o.threshold);
    if (DG) o.dg[i] = r;
    if (DX) o.dx[i] = t;
  }
}

__host__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

template <typename K>
int launch(const void* gg, const void* g, const void* x, void* dg, void* dx,
           long long n, long long g_cols, long long g_ld, float beta,
           float threshold, cudaStream_t stream) {
  using S = typename K::S;
  constexpr long long V = sizeof(uint4) / sizeof(S);
  const Operands<S> o = {static_cast<const S*>(gg), static_cast<const S*>(g),
                         static_cast<const S*>(x),  static_cast<S*>(dg),
                         static_cast<S*>(dx),       n,
                         g_cols,                    g_ld,
                         beta,                      threshold};
  const bool vectorized = aligned16(gg) && aligned16(x) &&
                          (!g || g_ld != g_cols || aligned16(g)) &&
                          (!dg || aligned16(dg)) && (!dx || aligned16(dx));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = vectorized ? (n + V - 1) / V : n;
  const unsigned grid = static_cast<unsigned>(
      std::min<long long>((items + kThreads - 1) / kThreads,
                          static_cast<long long>(sms) * kBlocksPerSM));
  const int vec = vectorized ? 1 : 0;
  if (dg && dx) {
    softplus_grad_grad_kernel<K, true, true>
        <<<grid, kThreads, 0, stream>>>(o, vec);
  } else if (dg) {
    softplus_grad_grad_kernel<K, true, false>
        <<<grid, kThreads, 0, stream>>>(o, vec);
  } else {
    softplus_grad_grad_kernel<K, false, true>
        <<<grid, kThreads, 0, stream>>>(o, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 (f32) or 1 (bf16): gg and x are device addresses of n
// contiguous values of it each, g of rows of g_cols values g_ld apart
// (g_ld >= g_cols >= 1, and g_cols divides n; g_ld == g_cols where g is
// contiguous), dg and dx of n contiguous values to write; dg or dx null
// skips that output, and g is read only for dx (it may be null without
// dx).  beta and threshold are the softplus's, as f32.  Launches on
// `stream` and returns the launch's cudaError_t (0 if none); when n is 0 it
// launches nothing and reads no other argument.
extern "C" int softplus_grad_grad(int dtype, const void* gg, const void* g,
                                  const void* x, void* dg, void* dx,
                                  long long n, long long g_cols,
                                  long long g_ld, float beta, float threshold,
                                  void* stream) {
  if (n == 0) return 0;
  if (n < 0 || !gg || !x || (!dg && !dx) || (dx && !g) || g_cols < 1 ||
      g_ld < g_cols || n % g_cols != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<F32>(gg, g, x, dg, dx, n, g_cols, g_ld, beta, threshold,
                         s);
    case 1:
      return launch<BF16>(gg, g, x, dg, dx, n, g_cols, g_ld, beta, threshold,
                          s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
