// Grid-feature scatter-add:
//   out[r] = sum_{i : ids[i] == r} vals[i]        (f32 sums, rows of width d)
// written densely: every row of the table, zero where no update lands.
//
// Replaces ndjir_tpu/ops/scatter_pallas.py:_scatter_kernel, the backward of
// every grid-feature gather (GatherRows and GatherRowsOcta in ndjir_torch).
//
// What bounds it on an H100: bytes.  At the dense voxel grids (2,097,152
// updates of d=4 f32 into 512^3 rows; 524,288 of d=32 bf16 into 256^3 rows,
// transposed) nearly all of them are the 2.15 GB dense output, written once.
// At the other encodings' shapes the output is small and the updates are
// many: 1,572,864 of d=8 into 6,144 triline rows, 3,145,728 of d=8 into
// 12,582,912 triplane rows, 33,554,432 of d=4 into 476,672 hash rows.  There
// the ids, the values and the sort dominate, and the work is to spread a
// few very heavy rows over the whole card.
//
// Design, in launch order (all on the caller's stream):
//  - scatter_keys_kernel maps each id to a 32-bit key, out-of-range ids
//    (negative, or >= num_rows, int64 included) to the sentinel num_rows,
//    and writes the identity permutation (int32).
//  - CUB's stable radix sort orders the keys over bit_length(num_rows) bits
//    only (13 for the lines, 19 for the hash, 28 for 512^3), carrying the
//    int32 permutation.  The values stay where they are, in their own dtype
//    (f32 or bf16), and are read through it.  (The TPU package sorts
//    outside its kernel too, with jax.lax.sort.)
//  - The output is cut into slabs of consecutive rows, sized by the caller
//    per width.  A pre-pass finds every slab's first sorted position: one
//    pass over the keys (scatter_slab_starts_kernel), or, where the slabs
//    are few against the keys (the hash: 1,862 slabs, 33.5M keys), a binary
//    search per slab (scatter_slab_search_kernel).  scatter_plan_kernel cuts
//    each slab with more than `piece` updates into pieces of `piece`
//    consecutive sorted positions and lists them.
//  - scatter_add_rows_kernel: every warp works alone, with its own slab of
//    shared memory and no block barrier.  It first takes the listed pieces
//    (warp w takes pieces w, w + warps, ...: they are all the same size),
//    then the other slabs 4 at a time from a counter; a run of slabs with
//    no update is written as one stretch of zeros.  A piece writes the rows
//    between its first and last ids (a whole slab writes all its rows), with
//    16-byte streaming stores.  A run of equal ids cut by a piece's edges is
//    not written there: the piece leaves its part of the run, in f32, in a
//    scratch line, the one before the cut as the "tail" and the one after
//    as the "head".
//  - scatter_fixup_kernel writes each cut run's row: the tail of the piece
//    where the run began, then the heads of the pieces it covers, summed in
//    a fixed tree order, one warp per run.  So a row that takes 108,650
//    updates is summed by ~200 warps and one fix-up, not by one block.
//  - Up to d=8 a warp's lanes are updates: 32 (times 2-4 in flight)
//    consecutive sorted updates at a time, each lane a whole row of up to 8
//    columns (16-byte loads where the rows allow); a segmented tree sum
//    across the lanes, in a fixed order, adds each run of equal ids and its
//    last lane adds the run's sum to the slab.  Above d=8 the lanes are
//    columns: a 64-byte bf16 row is one coalesced load, 16 updates' loads in
//    flight, and each lane sums its column of a run in sorted order.  The
//    transposed slab keeps one line per column, padded to an odd pitch so the
//    32 lanes writing one row hit 32 banks, and each column is written as
//    16-byte vectors of 4 consecutive rows.
// Every sum is taken in an order fixed by the sorted ids alone, and the
// sort is stable, so the result is bitwise identical from run to run; the
// only atomics count (the piece list and the slab counter), so which warp
// builds a piece may change but not what it writes.  Every output element
// is written by these kernels, so the output needs no zero fill beforehand.
// Ids outside [0, num_rows) fall in no slab and are dropped, as XLA's
// scatter drops them.
//
// Where a small table takes many updates a row (the voxel hash: 33.5M f32
// rows of 4 into 476,672 rows), that sorted path would spend most of its
// time sorting all 19 key bits and reading each 16-byte row at random
// through the permutation (a DRAM burst a row).  The bucket path (see
// BucketParams below) sorts by the top 8 key bits only, in one pass that
// carries the rows themselves, read in input order, and sums each bucket
// of 2,048 rows in shared memory.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;   // blocks an SM holds: at most 80 registers
constexpr int kChunk = 4;       // slabs a warp takes from the counter at once
constexpr int kInFlight = 16;   // lanes-are-columns: updates' loads in flight
constexpr unsigned kAll = 0xffffffffu;

// Scratch (int32), made by the caller: starts[num_slabs + 1], then the
// counters (pieces listed, slabs taken), then each cut slab's first place
// in the piece list, then, from the next even int, the piece list as
// (slab, index in the slab) pairs.
struct Scratch {
  int32_t* starts;
  int32_t* counters;
  int32_t* first;
  int2* pieces;
};

__host__ __device__ inline int pieces_offset(int num_slabs) {
  return (2 * num_slabs + 4) & ~1;
}

__host__ __device__ inline Scratch split_scratch(void* p, int num_slabs) {
  int32_t* s = static_cast<int32_t*>(p);
  return {s, s + num_slabs + 1, s + num_slabs + 3,
          reinterpret_cast<int2*>(s + pieces_offset(num_slabs))};
}

// key = id inside [0, num_rows), else the sentinel (>= num_rows); perm =
// i where perm is given
template <typename I>
__global__ void __launch_bounds__(256) scatter_keys_kernel(
    const I* __restrict__ ids, int n, int64_t num_rows, int64_t sentinel,
    uint32_t* __restrict__ keys, int32_t* __restrict__ perm) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int64_t id = static_cast<int64_t>(ids[i]);
  keys[i] = static_cast<uint32_t>(id >= 0 && id < num_rows ? id : sentinel);
  if (perm) perm[i] = i;
}

// the slab of a row id: -1 below the table, num_slabs at or past its end
__device__ __forceinline__ int slab_of(int32_t id, int64_t num_rows,
                                       int slab_rows, int num_slabs) {
  if (id < 0) return -1;
  if (id >= num_rows) return num_slabs;
  return id / slab_rows;
}

// starts[s] = the first sorted position whose id is >= min(s * slab_rows,
// num_rows), for s in [0, num_slabs].  Position i writes the starts of the
// slabs in (slab(ids[i-1]), slab(ids[i])]; position n closes the last ones.
// A long gap of empty slabs is written by the whole warp.  Also zeroes the
// counters.
__global__ void __launch_bounds__(256) scatter_slab_starts_kernel(
    const int32_t* __restrict__ ids, int n, int64_t num_rows, int slab_rows,
    int num_slabs, Scratch scratch) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i == 0) scratch.counters[0] = scratch.counters[1] = 0;
  int first = 0, last = -1;
  if (i <= n) {
    first = (i == 0 ? -1 : slab_of(ids[i - 1], num_rows, slab_rows,
                                   num_slabs)) + 1;
    last = i == n ? num_slabs
                  : slab_of(ids[i], num_rows, slab_rows, num_slabs);
  }
  const int lane = threadIdx.x & 31;
  for (unsigned todo = __ballot_sync(kAll, first <= last); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int a = __shfl_sync(kAll, first, src);
    const int b = __shfl_sync(kAll, last, src);
    const int pos = __shfl_sync(kAll, i, src);
    for (int s = a + lane; s <= b; s += 32) scratch.starts[s] = pos;
  }
}

// the same starts by a binary search each over the sorted keys, where the
// slabs are few against the ids
__global__ void __launch_bounds__(256) scatter_slab_search_kernel(
    const int32_t* __restrict__ ids, int n, int64_t num_rows, int slab_rows,
    int num_slabs, Scratch scratch) {
  const int s = blockIdx.x * 256 + threadIdx.x;
  if (s == 0) scratch.counters[0] = scratch.counters[1] = 0;
  if (s > num_slabs) return;
  const int64_t row = static_cast<int64_t>(s) * slab_rows;
  const int32_t bound = static_cast<int32_t>(row < num_rows ? row : num_rows);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = static_cast<int>((static_cast<int64_t>(lo) + hi) >> 1);
    if (ids[mid] < bound) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  scratch.starts[s] = lo;
}

// lists the pieces of every slab with more than `cut` updates (`piece`
// on the sorted path, 0 on the bucket path): one contiguous block of
// entries per slab, (slab, 0), (slab, 1), ..., whose place goes to
// first[slab]; the blocks in no particular order (each piece is built the
// same way wherever it stands in the list)
__global__ void __launch_bounds__(256) scatter_plan_kernel(
    int num_slabs, int piece, int cut, Scratch scratch) {
  const int s = blockIdx.x * 256 + threadIdx.x;
  if (s >= num_slabs) return;
  const int u = scratch.starts[s + 1] - scratch.starts[s];
  if (u <= cut) return;
  const int count = (u + piece - 1) / piece;
  const int base = atomicAdd(scratch.counters, count);
  scratch.first[s] = base;
  for (int k = 0; k < count; ++k) scratch.pieces[base + k] = make_int2(s, k);
}

// position of a float pointer within its 16-byte line, in floats
__device__ __forceinline__ int line_offset(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// dst[0, n) = src[0, n), or zeros when src is null, by lane t of nt >= 4,
// the body as 16-byte streaming stores.  kVecSrc: src + k sits at the same
// offset in its 16-byte line as dst + k, so the body reads 16-byte vectors.
template <bool kVecSrc>
__device__ __forceinline__ void put_range(float* dst, const float* src,
                                          int n, int t, int nt) {
  const int head = min(n, (4 - line_offset(dst)) & 3);
  const int nv = (n - head) >> 2;
  const int tail = head + 4 * nv;
  if (t < head) __stcs(dst + t, src ? src[t] : 0.0f);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  if (src) {
    for (int k = t; k < nv; k += nt) {
      const float* q = src + head + 4 * k;
      __stcs(d4 + k, kVecSrc ? *reinterpret_cast<const float4*>(q)
                             : make_float4(q[0], q[1], q[2], q[3]));
    }
  } else {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = t; k < nv; k += nt) __stcs(d4 + k, zero);
  }
  if (t < n - tail) __stcs(dst + tail + t, src ? src[tail + t] : 0.0f);
}

struct Params {
  const int32_t* ids;
  const int32_t* perm;
  const void* vals;
  float* out;
  float* partials;   // [2][max_pieces][d]: heads, then tails
  Scratch scratch;
  int64_t num_rows;
  int d, slab_rows, num_slabs, pitch, acc_floats, piece, max_pieces;
  bool transposed, vec;
};

// One slab's rows [row0, row0 + rows) and where its element (r, c) sits in
// shared memory: as (rows, d) after the output's offset in its 16-byte line,
// or, transposed, on line c of `pitch` floats.
struct Slab {
  float* out;
  int64_t num_rows, row0;
  int rows, d, pitch, off;
  bool transposed;

  __device__ Slab(const Params& p, int s)
      : out(p.out), num_rows(p.num_rows),
        row0(static_cast<int64_t>(s) * p.slab_rows),
        rows(static_cast<int>(p.num_rows - row0 < p.slab_rows
                                  ? p.num_rows - row0
                                  : p.slab_rows)),
        d(p.d), pitch(p.pitch),
        off(p.transposed ? 0 : line_offset(p.out + row0 * p.d)),
        transposed(p.transposed) {}

  __device__ int slot(int r, int c) const {
    return transposed ? c * pitch + r : off + r * d + c;
  }
  // this slab and the next n - 1 as zeros, by lane t of 32, a transposed
  // slab 4 columns at a time
  __device__ void write_zeros(int n, int t) const {
    const int64_t all = row0 + static_cast<int64_t>(n) * rows < num_rows
                            ? static_cast<int64_t>(n) * rows
                            : num_rows - row0;
    if (!transposed) {
      put_range<true>(out + row0 * d, nullptr, static_cast<int>(all * d), t,
                      32);
      return;
    }
    for (int c = t >> 3; c < d; c += 4) {
      put_range<false>(out + c * num_rows + row0, nullptr,
                       static_cast<int>(all), t & 7, 8);
    }
  }
  // rows [a, b) of the slab from acc, by lane t of 32
  __device__ void write_rows(const float* acc, int a, int b, int t) const {
    if (a >= b) return;
    if (!transposed) {
      put_range<true>(out + (row0 + a) * d, acc + off + a * d, (b - a) * d, t,
                      32);
      return;
    }
    for (int c = t >> 3; c < d; c += 4) {
      put_range<false>(out + c * num_rows + row0 + a, acc + c * pitch + a,
                       b - a, t & 7, 8);
    }
  }
  // rows [a, b) of acc set to zero, by lane t of 32
  __device__ void zero_rows(float* acc, int a, int b, int t) const {
    if (!transposed) {
      for (int k = off + a * d + t; k < off + b * d; k += 32) acc[k] = 0.0f;
      return;
    }
    for (int c = 0; c < d; ++c) {
      for (int r = a + t; r < b; r += 32) acc[c * pitch + r] = 0.0f;
    }
  }
};

// the row's first min(d, W) columns into v, zeros past them; vec: d == W
// and the rows are aligned to their size, so they load as 16-byte vectors
// (8-byte ones for a bf16 row of 4)
template <int W>
__device__ __forceinline__ void load_row(const float* p, int d, bool vec,
                                         float (&v)[W]) {
  if (vec) {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + h);
      v[4 * h] = f.x, v[4 * h + 1] = f.y, v[4 * h + 2] = f.z,
      v[4 * h + 3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] = c < d ? __ldg(p + c) : 0.0f;
}

template <int W>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, int d,
                                         bool vec, float (&v)[W]) {
  if (vec) {
    uint32_t w[W / 2];
    if constexpr (W == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x, w[1] = u.y;
    }
#pragma unroll
    for (int h = 0; h < W / 2; ++h) {
      // a bf16 is the top half of its f32
      v[2 * h] = __uint_as_float(w[h] << 16);
      v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] = c < d ? __bfloat162float(p[c]) : 0.0f;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Up to d=8 lanes are updates: sorted positions [lo, hi), 32 x R at a time,
// each round's runs added to what acc holds, so a run met by several rounds
// adds up in order.
template <typename V, int W>
__device__ void sum_by_updates(const Params& p, const Slab& slab, int lo,
                               int hi, float* acc, int lane) {
  constexpr int R = W == 4 ? 4 : 2;   // rounds in flight
  const V* vals = static_cast<const V*>(p.vals);
  for (int j0 = lo; j0 < hi; j0 += 32 * R) {
    int id[R];
    float x[R][W];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = j0 + 32 * q + lane;
      if (j < hi) {
        id[q] = p.ids[j];
        load_row<W>(vals + static_cast<int64_t>(p.perm[j]) * p.d, p.d,
                    p.vec, x[q]);
      } else {  // an id no valid lane has
        id[q] = -1 - lane;
#pragma unroll
        for (int c = 0; c < W; ++c) x[q][c] = 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (j0 + 32 * q >= hi) break;
      // segmented inclusive sum over the lanes, in a fixed tree order: the
      // ids are sorted, so equal ids `off` lanes apart bound one run
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kAll, id[q], off);
        float y[W];
#pragma unroll
        for (int c = 0; c < W; ++c) y[c] = __shfl_up_sync(kAll, x[q][c], off);
        if (lane >= off && up == id[q]) {
#pragma unroll
          for (int c = 0; c < W; ++c) x[q][c] += y[c];
        }
      }
      const int next = __shfl_down_sync(kAll, id[q], 1);
      if (j0 + 32 * q + lane < hi && (lane == 31 || next != id[q])) {
        const int r = static_cast<int>(id[q] - slab.row0);
#pragma unroll
        for (int c = 0; c < W; ++c) {
          if (c < p.d) acc[slab.slot(r, c)] += x[q][c];
        }
      }
      __syncwarp();
    }
  }
}

// Above d=8 lanes are columns c0 + lane: each lane sums its column of each
// run of [lo, hi) in sorted order and stores it once into acc.
template <typename V>
__device__ void sum_by_columns(const Params& p, const Slab& slab, int c0,
                               int lo, int hi, float* acc, int lane) {
  const V* vals = static_cast<const V*>(p.vals);
  const int c = c0 + lane;
  const bool col = c < p.d;
  int cur = p.ids[lo];
  float s = 0.0f;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const int my_id = j < hi ? p.ids[j] : 0;
    const int my_row = j < hi ? p.perm[j] : 0;
    const int nb = min(32, hi - j0);
    for (int b0 = 0; b0 < nb; b0 += kInFlight) {
      int idb[kInFlight];
      float v[kInFlight];
#pragma unroll
      for (int b = 0; b < kInFlight; ++b) {
        idb[b] = __shfl_sync(kAll, my_id, b0 + b);
        const int row = __shfl_sync(kAll, my_row, b0 + b);
        v[b] = b0 + b < nb && col
                   ? load1(vals + static_cast<int64_t>(row) * p.d + c)
                   : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < kInFlight; ++b) {
        if (b0 + b < nb) {
          if (idb[b] != cur) {
            if (col) acc[slab.slot(static_cast<int>(cur - slab.row0), c)] = s;
            cur = idb[b];
            s = 0.0f;
          }
          s += v[b];
        }
      }
    }
  }
  if (col) acc[slab.slot(static_cast<int>(cur - slab.row0), c)] = s;
}

// One piece [lo, hi) of slab s's sorted range [start, end), by one warp
// (at: its place in the piece list, or -1 for a whole slab).  It writes the
// rows from the one after the previous piece's last id (the slab's first
// row for its first piece) to its own last id (the slab's last row for its
// last piece), but the row of a run that goes on past hi, which goes to
// this piece's tail line, as the part of a run that began before lo goes to
// its head line.
template <typename V, int W>
__device__ void build_piece(const Params& p, int s, int at, int lo, int hi,
                            int start, int end, float* acc, int lane) {
  const Slab slab(p, s);
  const int head = static_cast<int>(p.ids[lo] - slab.row0);
  const int last = static_cast<int>(p.ids[hi - 1] - slab.row0);
  const bool left_open = lo > start && p.ids[lo - 1] == p.ids[lo];
  const bool right_open = hi < end && p.ids[hi] == p.ids[hi - 1];
  const bool tail = right_open && !(left_open && head == last);
  const int a = lo == start ? 0
                            : static_cast<int>(p.ids[lo - 1] - slab.row0) + 1;
  const int b = hi == end ? slab.rows : last + 1;
  if (at < 0) {   // the whole slab
    for (int k = lane; k < p.acc_floats / 4; k += 32) {
      reinterpret_cast<float4*>(acc)[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    slab.zero_rows(acc, a - left_open, b, lane);
  }
  __syncwarp();
  if constexpr (W > 0) {
    sum_by_updates<V, W>(p, slab, lo, hi, acc, lane);
  } else {
    for (int c0 = 0; c0 < p.d; c0 += 32) {
      sum_by_columns<V>(p, slab, c0, lo, hi, acc, lane);
    }
  }
  __syncwarp();
  if (left_open || tail) {
    float* heads = p.partials + static_cast<int64_t>(at) * p.d;
    float* tails = heads + static_cast<int64_t>(p.max_pieces) * p.d;
    for (int c = lane; c < p.d; c += 32) {
      if (left_open) heads[c] = acc[slab.slot(head, c)];
      if (tail) tails[c] = acc[slab.slot(last, c)];
    }
  }
  slab.write_rows(acc, a, b - tail, lane);
  __syncwarp();
}

template <typename V, int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scatter_add_rows_kernel(Params p) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = reinterpret_cast<float*>(smem) + warp * p.acc_floats;
  const int32_t* starts = p.scratch.starts;

  // 1. the pieces of the heavy slabs, all the same size, dealt round-robin
  const int n_pieces = p.scratch.counters[0];
  const int warps = gridDim.x * kWarps;
  for (int at = blockIdx.x * kWarps + warp; at < n_pieces; at += warps) {
    const int2 sk = p.scratch.pieces[at];
    const int start = starts[sk.x], end = starts[sk.x + 1];
    const int lo = start + sk.y * p.piece;
    build_piece<V, W>(p, sk.x, at, lo, min(lo + p.piece, end), start, end,
                      acc, lane);
  }

  // 2. every other slab, a warp each, taken kChunk at a time; a run of
  // empty slabs is written as one stretch of zeros
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(p.scratch.counters + 1, kChunk);
    base = __shfl_sync(kAll, base, 0);
    if (base >= p.num_slabs) break;
    const int count = min(kChunk, p.num_slabs - base);
    const int my_start = lane <= count ? starts[base + lane] : 0;
    const int my_end = __shfl_down_sync(kAll, my_start, 1);
    const unsigned empty = __ballot_sync(kAll, lane < count &&
                                                   my_start == my_end);
    for (int q = 0; q < count;) {
      if (empty >> q & 1) {
        const int run = min(count - q, __ffs(~(empty >> q)) - 1);
        Slab(p, base + q).write_zeros(run, lane);
        q += run;
        continue;
      }
      const int start = __shfl_sync(kAll, my_start, q);
      const int end = __shfl_sync(kAll, my_start, q + 1);
      if (end - start <= p.piece) {   // else built in step 1
        build_piece<V, W>(p, base + q, -1, start, end, start, end, acc, lane);
      }
      ++q;
    }
  }
}

// The rows of the runs cut by the pieces' edges, a warp each: the tail of
// the piece where the run began, plus the heads of the pieces after it
// that begin inside the run (lane l sums pieces l, l + 32, ... in order,
// then a tree across the lanes), 32 columns at a time.
__global__ void __launch_bounds__(kThreads) scatter_fixup_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int n_pieces = p.scratch.counters[0];
  const int warps = gridDim.x * kWarps;
  const float* heads = p.partials;
  const float* tails = p.partials + static_cast<int64_t>(p.max_pieces) * p.d;
  for (int at = blockIdx.x * kWarps + (threadIdx.x >> 5); at < n_pieces;
       at += warps) {
    const int2 sk = p.scratch.pieces[at];
    const int start = p.scratch.starts[sk.x], end = p.scratch.starts[sk.x + 1];
    const int lo = start + sk.y * p.piece, hi = min(lo + p.piece, end);
    const int32_t id = p.ids[hi - 1];
    const bool left_open = lo > start && p.ids[lo - 1] == p.ids[lo];
    const bool right_open = hi < end && p.ids[hi] == id;
    if (!right_open || (left_open && p.ids[lo] == id)) continue;
    for (int c0 = 0; c0 < p.d; c0 += 32) {
      const int nc = min(32, p.d - c0);
      float sum[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) sum[c] = 0.0f;
      for (int k0 = 1;; k0 += 32) {
        // piece at + k begins at hi + (k - 1) * piece
        const int64_t from =
            hi + static_cast<int64_t>(k0 - 1 + lane) * p.piece;
        const bool in = from < end && p.ids[from] == id;
        if (in) {
          const float* h =
              heads + static_cast<int64_t>(at + k0 + lane) * p.d + c0;
#pragma unroll
          for (int c = 0; c < 32; ++c) {
            if (c < nc) sum[c] += h[c];
          }
        }
        if (__ballot_sync(kAll, in) != kAll) break;
      }
      // lane 0 ends with the tree's total of column c0 + c in sum[c]; then
      // lane c writes it, the tail first
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          sum[c] += __shfl_down_sync(kAll, sum[c], off);
        }
      }
      float total = 0.0f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float v = __shfl_sync(kAll, sum[c], 0);
        if (lane == c) total = v;
      }
      if (lane < nc) {
        const int c = c0 + lane;
        const float v = tails[static_cast<int64_t>(at) * p.d + c] + total;
        if (p.transposed) {
          p.out[c * p.num_rows + id] = v;
        } else {
          p.out[static_cast<int64_t>(id) * p.d + c] = v;
        }
      }
    }
  }
}

// The bucket path, where a small table takes many updates per row (the
// voxel hash: 33.5M updates into 476,672 rows).  The sort orders the keys
// only by their bucket of bucket_rows rows (key >> bucket_bits: the top 8
// key bits, one radix pass) and carries the 16-byte rows (f32, d = 4)
// themselves, read once in input order; within a bucket the updates stay
// in input order.  scatter_bucket_kernel: one warp for each piece of
// `piece` consecutive updates of a bucket, with the bucket's rows (32 KB at
// 2,048 rows) in its own shared memory; 32 updates at a time, the lanes of
// one row (__match_any_sync) moved next to each other in a fixed order and
// summed by a segmented tree sum, whose last lane adds the sum to the row
// (ids at the table's hot cells land in one bucket many times a round).
// The piece's rows go to its partial line; scatter_bucket_combine_kernel
// sums a bucket's partials in piece order into every output row.
struct BucketParams {
  const int32_t* ids;
  const float4* vals;
  float4* partials;   // [pieces][bucket_rows]
  float4* out;
  Scratch scratch;
  int64_t num_rows;
  int bucket_rows, bucket_bits, piece;
};

__global__ void __launch_bounds__(32) scatter_bucket_kernel(BucketParams p) {
  extern __shared__ float4 rows[];   // then 32 ints: a round's new order
  int* order = reinterpret_cast<int*>(rows + p.bucket_rows);
  constexpr int R = 4;   // rounds of 32 in flight
  const int lane = threadIdx.x;
  const int n_pieces = p.scratch.counters[0];
  for (int at = blockIdx.x; at < n_pieces; at += gridDim.x) {
    const int2 sk = p.scratch.pieces[at];
    const int start = p.scratch.starts[sk.x], end = p.scratch.starts[sk.x + 1];
    const int lo = start + sk.y * p.piece, hi = min(lo + p.piece, end);
    const int row0 = sk.x << p.bucket_bits;
    for (int r = lane; r < p.bucket_rows; r += 32) {
      rows[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncwarp();
    for (int j0 = lo; j0 < hi; j0 += 32 * R) {
      int row[R];
      float4 v[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int j = j0 + 32 * q + lane;
        if (j < hi) {
          row[q] = p.ids[j] - row0;
          v[q] = __ldcs(p.vals + j);
        } else {  // a row no valid lane has
          row[q] = -1 - lane;
          v[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (j0 + 32 * q >= hi) break;
        // the lanes of one row (__match_any_sync) made neighbours: rows in
        // the order of their first lane, a row's lanes in lane order
        const unsigned same = __match_any_sync(kAll, row[q]);
        const int first = __ffs(same) - 1;
        const int size = first == lane ? __popc(same) : 0;
        int below = size;   // inclusive prefix of the rows' sizes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(kAll, below, off);
          if (lane >= off) below += t;
        }
        const int place = __shfl_sync(kAll, below - size, first) +
                          __popc(same & ((1u << lane) - 1));
        order[place] = lane;
        __syncwarp();
        const int src = order[lane];
        __syncwarp();
        const int r = __shfl_sync(kAll, row[q], src);
        float4 x;
        x.x = __shfl_sync(kAll, v[q].x, src);
        x.y = __shfl_sync(kAll, v[q].y, src);
        x.z = __shfl_sync(kAll, v[q].z, src);
        x.w = __shfl_sync(kAll, v[q].w, src);
        // each row's lanes summed in a fixed tree order; its last lane adds
        // the sum to the row
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int up = __shfl_up_sync(kAll, r, off);
          const float a = __shfl_up_sync(kAll, x.x, off);
          const float b = __shfl_up_sync(kAll, x.y, off);
          const float c = __shfl_up_sync(kAll, x.z, off);
          const float d = __shfl_up_sync(kAll, x.w, off);
          if (lane >= off && up == r) x.x += a, x.y += b, x.z += c, x.w += d;
        }
        const int next = __shfl_down_sync(kAll, r, 1);
        if (r >= 0 && (lane == 31 || next != r)) {
          float4& to = rows[r];
          to.x += x.x, to.y += x.y, to.z += x.z, to.w += x.w;
        }
        __syncwarp();
      }
    }
    __syncwarp();
    float4* line = p.partials + static_cast<int64_t>(at) * p.bucket_rows;
    for (int r = lane; r < p.bucket_rows; r += 32) line[r] = rows[r];
    __syncwarp();
  }
}

// out row r of bucket b = the sum of b's partial lines in piece order
// (zero where no update lands), one thread a row
__global__ void __launch_bounds__(256) scatter_bucket_combine_kernel(
    BucketParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= p.num_rows) return;
  const int b = static_cast<int>(i >> p.bucket_bits);
  const int r =
      static_cast<int>(i - (static_cast<int64_t>(b) << p.bucket_bits));
  const int u = p.scratch.starts[b + 1] - p.scratch.starts[b];
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (u > 0) {
    const float4* line =
        p.partials + static_cast<int64_t>(p.scratch.first[b]) * p.bucket_rows;
    for (int k = 0; k < (u + p.piece - 1) / p.piece; ++k) {
      const float4 x = line[static_cast<int64_t>(k) * p.bucket_rows + r];
      sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
    }
  }
  __stcs(p.out + i, sum);
}

template <typename V, int W>
int launch(const Params& p, cudaStream_t stream) {
  const int64_t smem = 4 * static_cast<int64_t>(kWarps) * p.acc_floats;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = scatter_add_rows_kernel<V, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<sms * per_sm, kThreads, static_cast<size_t>(smem), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_fixup_kernel<<<sms * 4, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int num_slabs_of(long long num_rows, int slab_rows) {
  return static_cast<int>((num_rows + slab_rows - 1) / slab_rows);
}

bool bad_shape(long long n, long long num_rows, int slab_rows) {
  return n < 0 || n > 0x7fffff00LL || num_rows < 1 ||
         num_rows > 0x7fffffffLL || slab_rows < 1 ||
         (num_rows + slab_rows - 1) / slab_rows > 0x3fffff00LL;
}

// the sort's key bits: enough for every row and the sentinel num_rows
int key_bits(long long num_rows) {
  int bits = 1;
  while ((1LL << bits) <= num_rows) ++bits;
  return bits;
}

struct Row16 {   // a value row the bucket path's sort carries
  float4 v;
};

// the key a sort maps ids outside the table to: num_rows, or on the bucket
// path the first row of the bucket past the table, so that it falls in no
// bucket of the table
long long sentinel_of(long long num_rows, int bucket_bits) {
  const long long rows = 1LL << bucket_bits;
  return (num_rows + rows - 1) / rows * rows;
}

cudaError_t radix_sort(void* temp, size_t* temp_bytes, const uint32_t* keys_in,
                       uint32_t* keys_out, const void* vals_in,
                       void* vals_out, int n, long long sentinel,
                       int begin_bit, cudaStream_t stream) {
  const int end_bit = key_bits(sentinel);
  if (begin_bit == 0) {   // the permutation
    return cub::DeviceRadixSort::SortPairs(
        temp, *temp_bytes, keys_in, keys_out,
        static_cast<const int32_t*>(vals_in), static_cast<int32_t*>(vals_out),
        n, 0, end_bit, stream);
  }
  return cub::DeviceRadixSort::SortPairs(   // the 16-byte rows
      temp, *temp_bytes, keys_in, keys_out, static_cast<const Row16*>(vals_in),
      static_cast<Row16*>(vals_out), n, begin_bit, end_bit, stream);
}

}  // namespace

// Scratch bytes of the sort of n ids into num_rows rows (bucket_bits 0: by
// key, carrying the permutation; else by bucket, carrying 16-byte rows),
// into *bytes.
extern "C" int scatter_sort_bytes(long long n, long long num_rows,
                                  int bucket_bits, size_t* bytes) {
  if (bad_shape(n, num_rows, 1) || bucket_bits < 0 || bucket_bits > 12) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(radix_sort(
      nullptr, bytes, nullptr, nullptr, nullptr, nullptr,
      static_cast<int>(n), sentinel_of(num_rows, bucket_bits), bucket_bits,
      nullptr));
}

// ids: (n,) int32 (ids64 = 0) or int64 (ids64 = 1); keys: (2, n) int32;
// temp: scatter_sort_bytes(n, num_rows, bucket_bits) bytes.  Maps the ids
// to keys in keys[0] (ids outside [0, num_rows) to the sentinel: num_rows,
// or on the bucket path the first row of the bucket past the table), then
// sorts them stably into keys[1].  With bucket_bits 0: over all the key
// bits, carrying the permutation: vals_in is (n,) int32 and gets the
// identity first, vals_out (n,) int32.  Else only by bucket (key >>
// bucket_bits), carrying vals_in's (n, 4) f32 rows into vals_out.
// Returns a cudaError_t.
extern "C" int scatter_sort(const void* ids, int ids64, long long n,
                            long long num_rows, int bucket_bits, void* keys,
                            void* vals_in, void* vals_out, void* temp,
                            size_t temp_bytes, void* stream) {
  if (bad_shape(n, num_rows, 1) || bucket_bits < 0 || bucket_bits > 12) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<uint32_t*>(keys);
  auto* iota = bucket_bits == 0 ? static_cast<int32_t*>(vals_in) : nullptr;
  const long long sentinel = sentinel_of(num_rows, bucket_bits);
  const int blocks = static_cast<int>((n + 255) / 256);
  if (ids64) {
    scatter_keys_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const int64_t*>(ids), static_cast<int>(n), num_rows,
        sentinel, k, iota);
  } else {
    scatter_keys_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const int32_t*>(ids), static_cast<int>(n), num_rows,
        sentinel, k, iota);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = radix_sort(temp, &temp_bytes, k, k + n, vals_in, vals_out,
                   static_cast<int>(n), sentinel, bucket_bits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ids: (n,) int32 keys sorted ascending; scratch: ((num_slabs + 4) & ~1)
// + 2 * max_pieces int32, where num_slabs = ceil(num_rows / slab_rows) and
// max_pieces = 2 * ceil(n / piece) + 1; writes each slab's first sorted
// position (scratch[0, num_slabs]: by one pass over the keys, or by a
// binary search per slab where that reads fewer), the number of pieces
// (scratch[num_slabs + 1]) and the piece list (from
// scratch[(num_slabs + 4) & ~1]).  Returns cudaErrorInvalidValue for
// arguments out of range, else the launches' cudaGetLastError().
extern "C" int scatter_plan(const void* ids, long long n, long long num_rows,
                            int slab_rows, int piece, int cut, void* scratch,
                            void* stream) {
  if (bad_shape(n, num_rows, slab_rows) || piece < 1 || cut < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int num_slabs = num_slabs_of(num_rows, slab_rows);
  const Scratch sc = split_scratch(scratch, num_slabs);
  const auto* keys = static_cast<const int32_t*>(ids);
  int steps = 1;
  while ((1LL << steps) <= n) ++steps;
  if ((num_slabs + 1LL) * steps < n) {
    scatter_slab_search_kernel<<<(num_slabs + 1 + 255) / 256, 256, 0, s>>>(
        keys, static_cast<int>(n), num_rows, slab_rows, num_slabs, sc);
  } else {
    scatter_slab_starts_kernel<<<static_cast<int>((n + 1 + 255) / 256), 256,
                                 0, s>>>(keys, static_cast<int>(n), num_rows,
                                         slab_rows, num_slabs, sc);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_plan_kernel<<<(num_slabs + 255) / 256, 256, 0, s>>>(
      num_slabs, piece, cut, sc);
  return static_cast<int>(cudaGetLastError());
}

// ids: (n,) int32 keys sorted ascending; perm: (n,) int32, the sort's
// permutation (ids[i] is the id of vals row perm[i]); vals: (n, d) f32
// (bf16 = 0) or bf16 (bf16 = 1), contiguous, in input order; scratch: as
// scatter_plan left it; partials: 2 * max_pieces * d f32; out:
// (num_rows, d) f32, or (d, num_rows) when transposed; every element of
// out is written.  All pointers are device pointers; stream is a
// cudaStream_t.  Needs 1 <= d <= 1024 and the warps' slabs in shared
// memory.  Returns
// cudaErrorInvalidValue for arguments out of range, else the launches'
// cudaGetLastError().
extern "C" int scatter_add_rows(const void* ids, const void* perm,
                                const void* vals, int bf16, void* scratch,
                                void* partials, void* out, long long n, int d,
                                long long num_rows, int slab_rows,
                                int transposed, int piece, void* stream) {
  if (bad_shape(n, num_rows, slab_rows) || d < 1 || d > 1024 || piece < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.ids = static_cast<const int32_t*>(ids);
  p.perm = static_cast<const int32_t*>(perm);
  p.vals = vals;
  p.out = static_cast<float*>(out);
  p.partials = static_cast<float*>(partials);
  p.num_rows = num_rows;
  p.d = d;
  p.slab_rows = slab_rows;
  p.num_slabs = num_slabs_of(num_rows, slab_rows);
  p.scratch = split_scratch(scratch, p.num_slabs);
  p.piece = piece;
  p.max_pieces = static_cast<int>(2 * ((n + piece - 1) / piece) + 1);
  p.transposed = transposed != 0;
  // an odd pitch: 32 lanes writing one row of 32 columns hit 32 banks
  p.pitch = slab_rows | 1;
  p.acc_floats = ((p.transposed ? d * p.pitch : slab_rows * d + 3) + 3) & ~3;
  const int w = d <= 4 ? 4 : d <= 8 ? 8 : 0;
  const size_t row_bytes = static_cast<size_t>(d) * (bf16 ? 2 : 4);
  p.vec = d == w && (reinterpret_cast<uintptr_t>(vals) % row_bytes) == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return w == 4   ? launch<__nv_bfloat16, 4>(p, s)
           : w == 8 ? launch<__nv_bfloat16, 8>(p, s)
                    : launch<__nv_bfloat16, 0>(p, s);
  }
  return w == 4   ? launch<float, 4>(p, s)
         : w == 8 ? launch<float, 8>(p, s)
                  : launch<float, 0>(p, s);
}

// The bucket path (see BucketParams): ids: (n,) int32 keys sorted by
// key >> bucket_bits, stably; vals: (n, 4) f32 in the keys' order, 16-byte
// aligned; scratch: as scatter_plan(ids, n, num_rows, 1 << bucket_bits,
// piece, 0, ...) left it; partials: (ceil(n / piece) + num_buckets) *
// (1 << bucket_bits) * 4 f32, num_buckets = ceil(num_rows >> bucket_bits);
// out: (num_rows, 4) f32, every element written.  Needs a bucket's rows
// (16 << bucket_bits bytes, and 128 more) in shared memory.  Returns
// cudaErrorInvalidValue for arguments out of range, else the launches'
// cudaGetLastError().
extern "C" int scatter_add_rows_buckets(const void* ids, const void* vals,
                                        void* scratch, void* partials,
                                        void* out, long long n,
                                        long long num_rows, int bucket_bits,
                                        int piece, void* stream) {
  if (bucket_bits < 0 || bucket_bits > 12 || piece < 1 ||
      bad_shape(n, num_rows, 1 << bucket_bits) ||
      (reinterpret_cast<uintptr_t>(vals) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BucketParams p;
  p.ids = static_cast<const int32_t*>(ids);
  p.vals = static_cast<const float4*>(vals);
  p.partials = static_cast<float4*>(partials);
  p.out = static_cast<float4*>(out);
  p.num_rows = num_rows;
  p.bucket_bits = bucket_bits;
  p.bucket_rows = 1 << bucket_bits;
  p.scratch = split_scratch(scratch, num_slabs_of(num_rows, p.bucket_rows));
  p.piece = piece;
  const int smem = (16 << bucket_bits) + 128;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_bucket_kernel, 32, static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  scatter_bucket_kernel<<<sms * per_sm, 32, static_cast<size_t>(smem), s>>>(
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_bucket_combine_kernel<<<static_cast<int>((num_rows + 255) / 256),
                                  256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
