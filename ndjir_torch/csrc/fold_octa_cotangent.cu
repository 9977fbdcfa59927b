// Octa cotangent fold: the adjoint of the octa table build.
//
// The octa table (ndjir_torch/ops/grid.py, GatherRowsOcta) holds in row
// (x, y, z) the features of the 8 cells (x+dx, y+dy, z+dz), channel block
// b = dx*4 + dy*2 + dz, each +1 neighbour clamped to the last slice of its
// axis.  Its backward scatters the rows' cotangent into a transposed
// (8D, M) f32 table, M = Gx*Gy*Gz (the scatter kernel), and this kernel
// folds that back onto the (Gx, Gy, Gz, D) base table: three halving passes,
// x then y then z, each
//   a'[i] = (a[i] + b[i - delta] * [coord(i) >= 1]) + b[i] * [coord(i) == L-1]
// with (delta, L) = (Gy*Gz, Gx), (Gz, Gy), (1, Gz), where a is the first half
// of the channels and b the second.
//
// Replaces ndjir_tpu/ops/fold_pallas.py:_fold_kernel.
//
// What bounds it on an H100: bytes.  At the training step's shape (D=4,
// G=256) it reads the 2.15 GB cotangent once and writes the 134 MB bf16
// table once; there are at most 26 adds per output.
//
// Design: one thread per output element (cell, d), in output order, so a
// warp reads 8 consecutive cells from each of 4 channel rows (whole 32-byte
// sectors) and writes 32 consecutive outputs.  Each thread evaluates the
// three passes for its own element straight from the input: 8 reads in the
// interior, up to 27 at the far corner, where every axis adds both the
// shifted neighbour and the clamped duplicate.  The expression tree, masked
// terms included as +0, is that of the plain version
// (_fold_octa_cotangent_plain), so the f32 result is bitwise the same and
// the same from run to run.  The one rounding to the output type is
// round-to-nearest-even.  Shared-memory tiling of the reused neighbours is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Shape {
  int64_t m;   // cells, Gx*Gy*Gz
  int64_t sx;  // Gy*Gz
  int gx, gy, gz, d;
};

// Pass x: channel k of the 4D-channel result at cell i (x coordinate cx).
__device__ __forceinline__ float fold_x(const float* __restrict__ c,
                                        const Shape& s, int k, int64_t i,
                                        int cx) {
  const float* a = c + static_cast<int64_t>(k) * s.m;
  const float* b = c + static_cast<int64_t>(k + 4 * s.d) * s.m;
  const float shifted = cx >= 1 ? b[i - s.sx] : 0.0f;
  const float edge = cx == s.gx - 1 ? b[i] : 0.0f;
  return (a[i] + shifted) + edge;
}

// Pass y on top of pass x: channel k of the 2D-channel result.
__device__ __forceinline__ float fold_xy(const float* __restrict__ c,
                                         const Shape& s, int k, int64_t i,
                                         int cx, int cy) {
  const float a = fold_x(c, s, k, i, cx);
  const float shifted = cy >= 1 ? fold_x(c, s, k + 2 * s.d, i - s.gz, cx)
                                : 0.0f;
  const float edge = cy == s.gy - 1 ? fold_x(c, s, k + 2 * s.d, i, cx) : 0.0f;
  return (a + shifted) + edge;
}

__device__ __forceinline__ void store(float* out, int64_t e, float v) {
  out[e] = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* out, int64_t e, float v) {
  out[e] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fold_octa_cotangent_kernel(
    const float* __restrict__ c, T* __restrict__ out, Shape s) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= s.m * s.d) return;
  const int64_t i = e / s.d;
  const int d = static_cast<int>(e - i * s.d);
  const int cz = static_cast<int>(i % s.gz);
  const int cy = static_cast<int>((i / s.gz) % s.gy);
  const int cx = static_cast<int>(i / s.sx);
  // pass z on top of passes x and y
  const float a = fold_xy(c, s, d, i, cx, cy);
  const float shifted = cz >= 1 ? fold_xy(c, s, d + s.d, i - 1, cx, cy)
                                : 0.0f;
  const float edge = cz == s.gz - 1 ? fold_xy(c, s, d + s.d, i, cx, cy)
                                    : 0.0f;
  store(out, e, (a + shifted) + edge);
}

}  // namespace

// cot: (8d, gx*gy*gz) f32, contiguous; out: (gx, gy, gz, d), contiguous,
// bf16 when out_bf16 else f32; every element of out is written.  Device
// pointers; stream is a cudaStream_t.  Returns cudaErrorInvalidValue for
// sizes out of range, else the launch's cudaGetLastError().
extern "C" int fold_octa_cotangent(const void* cot, void* out, int gx, int gy,
                                   int gz, int d, int out_bf16,
                                   void* stream) {
  if (gx < 1 || gy < 1 || gz < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s;
  s.gx = gx;
  s.gy = gy;
  s.gz = gz;
  s.d = d;
  s.sx = static_cast<int64_t>(gy) * gz;
  s.m = s.sx * gx;
  const int64_t n = s.m * d;
  // the largest input offset, (8d - 1) * m + m - 1, must fit in int64 (it
  // does for any table that fits in memory); the grid, in 2^31 - 1 blocks
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    fold_octa_cotangent_kernel<__nv_bfloat16>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
            static_cast<const float*>(cot), static_cast<__nv_bfloat16*>(out),
            s);
  } else {
    fold_octa_cotangent_kernel<float>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
            static_cast<const float*>(cot), static_cast<float*>(out), s);
  }
  return static_cast<int>(cudaGetLastError());
}
