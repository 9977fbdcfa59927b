// Octa table build: the (Gx, Gy, Gz, D) base table -> the (Gx*Gy*Gz, 8D)
// table whose row r = (x*Gy + y)*Gz + z holds, in channel block
// c = dx*4 + dy*2 + dz, the features of cell
//   (min(x+dx, Gx-1), min(y+dy, Gy-1), min(z+dz, Gz-1)).
// A query reads one contiguous 8D row per point from it instead of eight
// scattered corner cells (ndjir_torch/ops/grid.py).
//
// Replaces scripts/probe_build_variants.py:_pallas_octa_kernel (the Pallas
// form of ndjir_tpu/ops/grid.py:_voxel_octa_flat).
//
// What bounds it on an H100: bytes.  It is a pure copy with no arithmetic:
// at the inference shape (G=256, D=4, bf16) it reads the 134 MB base table
// once and writes the 1.07 GB table once, 0.36 ms at 3.35 TB/s.
//
// Design: dtype-agnostic byte copy.  One thread per W-byte chunk of the
// output (W = 16 where the row allows it), chunks in output order, so a
// warp's stores are contiguous and whole 16-byte vectors.  A chunk is made
// of K pieces of P bytes each (W = K*P): either K whole cells of the row's
// consecutive channel blocks (P = cell bytes, e.g. D=4 bf16: two 8-byte
// cells, dz = 0 and 1) or one P-byte slice of a single cell (a cell of 16
// bytes or more).  Each piece is one aligned load from the base table, so
// consecutive threads read consecutive cells; each base cell is read by up
// to 8 rows, which L1/L2 serve.  The result is the base table's bits, so it
// equals the plain version bitwise.  TMA and shared-memory staging of the
// two x-slices a row block reads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int P>
struct Bytes;
template <>
struct Bytes<1> { using T = uint8_t; };
template <>
struct Bytes<2> { using T = uint16_t; };
template <>
struct Bytes<4> { using T = uint32_t; };
template <>
struct Bytes<8> { using T = uint2; };
template <>
struct Bytes<16> { using T = uint4; };

struct Shape {
  int64_t chunks;  // output chunks: Gx*Gy*Gz * row_bytes / W
  int64_t row;     // output row bytes, 8 * cell
  int64_t cell;    // base cell bytes, D * sizeof(dtype)
  int gx, gy, gz;
};

// K pieces of P bytes, read from their base cells, stored as one K*P-byte
// vector.
template <int P, int K>
__global__ void __launch_bounds__(kThreads) build_octa_table_kernel(
    const uint8_t* __restrict__ base, uint8_t* __restrict__ out, Shape s) {
  using Piece = typename Bytes<P>::T;
  using Chunk = typename Bytes<P * K>::T;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= s.chunks) return;
  const int64_t o = t * (P * K);     // output byte offset
  const int64_t r = o / s.row;       // output row = (x*gy + y)*gz + z
  const int64_t q = o - r * s.row;   // byte offset within the row
  const int z = static_cast<int>(r % s.gz);
  const int64_t xy = r / s.gz;
  const int y = static_cast<int>(xy % s.gy);
  const int x = static_cast<int>(xy / s.gy);
  union {
    Chunk chunk;
    Piece piece[K];
  } v;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t qj = q + j * P;
    const int c = static_cast<int>(qj / s.cell);  // channel block
    const int64_t b = qj - c * s.cell;            // byte within the cell
    const int cx = min(x + (c >> 2), s.gx - 1);
    const int cy = min(y + ((c >> 1) & 1), s.gy - 1);
    const int cz = min(z + (c & 1), s.gz - 1);
    const int64_t cell =
        (static_cast<int64_t>(cx) * s.gy + cy) * s.gz + cz;
    v.piece[j] = *reinterpret_cast<const Piece*>(base + cell * s.cell + b);
  }
  *reinterpret_cast<Chunk*>(out + o) = v.chunk;
}

template <int P, int K>
cudaError_t launch(const void* base, void* out, const Shape& s,
                   cudaStream_t st) {
  const int64_t blocks = (s.chunks + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  build_octa_table_kernel<P, K>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
          static_cast<const uint8_t*>(base), static_cast<uint8_t*>(out), s);
  return cudaGetLastError();
}

}  // namespace

// base: (gx, gy, gz, d) contiguous, elem_bytes per element; out: (gx*gy*gz,
// 8d) contiguous, same element type; every byte of out is written.  Device
// pointers; stream is a cudaStream_t.  Returns cudaErrorInvalidValue for
// sizes out of range, else the launch's cudaGetLastError().
extern "C" int build_octa_table(const void* base, void* out, int gx, int gy,
                                int gz, int d, int elem_bytes, void* stream) {
  if (gx < 1 || gy < 1 || gz < 1 || d < 1 || elem_bytes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s;
  s.gx = gx;
  s.gy = gy;
  s.gz = gz;
  s.cell = static_cast<int64_t>(d) * elem_bytes;
  s.row = 8 * s.cell;
  const int64_t cells = static_cast<int64_t>(gx) * gy * gz;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(base) | reinterpret_cast<uintptr_t>(out);
  // whole cells packed into a 16-byte chunk: 16 % cell == 0, and the row
  // (8 cells) a whole number of chunks
  if (s.cell <= 8 && 16 % s.cell == 0 && s.row % 16 == 0 && align % 16 == 0) {
    s.chunks = cells * s.row / 16;
    switch (s.cell) {
      case 2: return static_cast<int>(launch<2, 8>(base, out, s, st));
      case 4: return static_cast<int>(launch<4, 4>(base, out, s, st));
      case 8: return static_cast<int>(launch<8, 2>(base, out, s, st));
    }
  }
  // one P-byte slice of one cell per thread: P the largest power of two up
  // to 16 that divides the cell and both pointers
  int p = 16;
  while (p > 1 && (s.cell % p != 0 || align % p != 0)) p /= 2;
  s.chunks = cells * s.row / p;
  switch (p) {
    case 16: return static_cast<int>(launch<16, 1>(base, out, s, st));
    case 8: return static_cast<int>(launch<8, 1>(base, out, s, st));
    case 4: return static_cast<int>(launch<4, 1>(base, out, s, st));
    case 2: return static_cast<int>(launch<2, 1>(base, out, s, st));
    default: return static_cast<int>(launch<1, 1>(base, out, s, st));
  }
}
