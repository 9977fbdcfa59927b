// The forward of every grid query's row gather (ndjir_torch/ops/scatter.py:
// GatherRows): out[i] = table[ids[i]] for a contiguous (M, D) table of any
// dtype and n ids (int32 or int64) in the caller's order, the same bits as
// table.index_select(0, ids).  It copies bytes and computes nothing.
//
// Replaces no TPU kernel: the JAX package's forward gather is plain XLA
// (ndjir_tpu/ops/scatter_pallas.py: gather_rows).  It was added for
// PyTorch's launch geometry: index_select of rows that are 16-byte aligned
// takes vectorized_gather_kernel, one block per id whose threads are the
// row's 16-byte pieces rounded up to a warp, so a D=4 f32 row costs a
// 32-thread block with one thread working and the block-dispatch rate sets
// the pace (~1.6 G rows/s on an H100 whether the table sits in HBM or L2).
//
// What bounds it on an H100: bytes, the ids read and the rows written once
// each and each distinct row read once, at 3.35 TB/s: 0.24 ms for the hash
// query's 33.5M ids of 16-byte rows, whose 7.6 MB table stays in L2.
//
// Design: a row is `lanes` vectors of `width` bytes (the wrapper takes the
// widest of 16, 8, 4, 2 and 1 bytes that divides the row and both base
// addresses, so a D=4 f32 row is one 16-byte vector), and a thread copies
// one vector.  A block of 256 threads takes 4 x 256 consecutive vectors at
// a time: each thread first loads the ids of its 4 (coalesced), then the 4
// vectors through the read-only path, then stores them (coalesced), so
// every thread keeps 4 row loads in flight.  A grid-stride loop over as
// many blocks as the card holds at once.  An id outside [0, M) is a
// device-side assertion, as under index_select: nothing outside the table
// is read.  Nothing is allocated here and nothing waits on the card.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;  // vectors a thread has in flight

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const V* __restrict__ table, const I* __restrict__ ids,
                       V* __restrict__ out, long long items, long long rows,
                       long long lanes, int shift) {
  const long long stride =
      static_cast<long long>(gridDim.x) * kThreads * kAhead;
  for (long long first =
           static_cast<long long>(blockIdx.x) * kThreads * kAhead +
           threadIdx.x;
       first < items; first += stride) {
    long long from[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long t = first + j * kThreads;
      from[j] = -1;
      if (t < items) {
        // the vector's row and lane: a shift where lanes is a power of 2
        const long long r = shift >= 0 ? t >> shift : t / lanes;
        const long long id = static_cast<long long>(__ldg(ids + r));
        if (id < 0 || id >= rows) {
          assert(!"gather_rows: an id lies outside the table");
          __trap();
        }
        from[j] = id * lanes + (t - r * lanes);
      }
    }
    V v[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (from[j] >= 0) v[j] = __ldg(table + from[j]);
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (from[j] >= 0) out[first + j * kThreads] = v[j];
    }
  }
}

template <typename V, typename I>
int launch(const void* table, const void* ids, void* out, long long n,
           long long rows, long long lanes, cudaStream_t stream) {
  // blocks an SM holds at once, asked once per instantiation
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_rows_kernel<V, I>, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = std::max(per_sm, 1);
  }
  int shift = -1;
  for (int s = 0; s < 62; ++s) {
    if ((1LL << s) == lanes) shift = s;
  }
  const long long items = n * lanes;
  const long long per_block = static_cast<long long>(kThreads) * kAhead;
  const unsigned grid = static_cast<unsigned>(
      std::min<long long>((items + per_block - 1) / per_block,
                          static_cast<long long>(sms) * per_sm));
  gather_rows_kernel<V, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const I*>(ids),
      static_cast<V*>(out), items, rows, lanes, shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_ids(const void* table, const void* ids, int ids_int64, void* out,
               long long n, long long rows, long long lanes,
               cudaStream_t stream) {
  return ids_int64
             ? launch<V, long long>(table, ids, out, n, rows, lanes, stream)
             : launch<V, int>(table, ids, out, n, rows, lanes, stream);
}

}  // namespace

// table: device address of `rows` rows of `row_bytes` bytes each,
// contiguous; ids: n int32 (ids_int64 0) or int64 (1) row ids; out: n rows
// of row_bytes to write.  width (16, 8, 4, 2 or 1) divides row_bytes and
// both table's and out's addresses.  Launches on `stream` and returns the
// launch's cudaError_t (0 if none); when n is 0 it launches nothing and
// reads no other argument.
extern "C" int gather_rows(const void* table, const void* ids, int ids_int64,
                           void* out, long long n, long long rows,
                           long long row_bytes, int width, void* stream) {
  if (n == 0) return 0;
  const bool width_ok =
      width == 16 || width == 8 || width == 4 || width == 2 || width == 1;
  if (n < 0 || rows < 1 || row_bytes < 1 || !table || !ids || !out ||
      !width_ok || row_bytes % width != 0 ||
      reinterpret_cast<uintptr_t>(table) % width != 0 ||
      reinterpret_cast<uintptr_t>(out) % width != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long lanes = row_bytes / width;
  auto s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16:
      return launch_ids<uint4>(table, ids, ids_int64, out, n, rows, lanes, s);
    case 8:
      return launch_ids<uint2>(table, ids, ids_int64, out, n, rows, lanes, s);
    case 4:
      return launch_ids<unsigned int>(table, ids, ids_int64, out, n, rows,
                                      lanes, s);
    case 2:
      return launch_ids<unsigned short>(table, ids, ids_int64, out, n, rows,
                                        lanes, s);
    default:
      return launch_ids<unsigned char>(table, ids, ids_int64, out, n, rows,
                                       lanes, s);
  }
}
