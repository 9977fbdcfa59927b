// Grid-feature scatter-add over row ids sorted ascending:
//   out[r] = sum_{i : ids[i] == r} vals[i]        (f32 sums, rows of width d)
// written densely: every row of the table, zero where no update lands.
//
// Replaces ndjir_tpu/ops/scatter_pallas.py:_scatter_kernel, the backward of
// every grid-feature gather (GatherRows and GatherRowsOcta in ndjir_torch).
//
// What bounds it on an H100: bytes, and nearly all of them are the dense
// output.  At the default step (2,097,152 updates of d=4 f32 into 512^3 rows)
// and at the octa step (524,288 updates of d=32 bf16 into 256^3 rows,
// transposed) the output is 2.15 GB, written once, against 25-42 MB of ids
// and values read; there is one add per updated value.  The kernel cannot
// take less than the output write at the card's memory rate, so its design
// keeps that store stream busy and spends as little as it can elsewhere.
//
// Design.  The caller sorts the ids (stable, so equal ids keep their input
// order) and hands over the sort's permutation; the values stay where they
// are, in their own dtype (f32 or bf16), and are read through it.  The
// output is cut into slabs of consecutive rows, sized by the caller (256
// rows at d=4, 64 at d=32); at the training steps half the slabs or fewer
// take updates, most of them a few.
//  - A pre-pass (scatter_slab_starts_kernel) turns the sorted ids into the
//    first sorted position of every slab, in one pass over the ids, and a
//    second one (scatter_heavy_slabs_kernel) lists the slabs that take more
//    updates than one warp sums quickly.
//  - The main kernel's warps work alone: each takes slabs 16 at a time from
//    a counter and builds each slab with updates in its own shared memory,
//    with no block barrier, so many independent slabs per SM hide each
//    other's load latency.  A run of slabs with no update is written as one
//    stretch of zeros straight from registers.  The output is written once,
//    with 16-byte streaming stores (scalar ones at a stretch's unaligned
//    ends).
//  - Up to d=4 a warp's lanes are updates: 32 (times 4 in flight) consecutive
//    sorted updates at a time, each lane a whole row; a segmented tree sum
//    across the lanes, in a fixed order, adds each run of equal ids and its
//    last lane adds the run's sum to the slab.  Above d=4 the lanes are
//    columns: a 64-byte bf16 row is one coalesced load, 16 updates' loads in
//    flight, and each lane sums its column of a run in sorted order.  The
//    transposed slab keeps one line per column, padded to an odd pitch so the
//    32 lanes writing one row hit 32 banks, and each column is written as
//    16-byte vectors of 4 consecutive rows.
//  - Ids cluster hard in training: points that leave the grid clamp to its
//    border cells, and at the default step one row takes 77,312 of 2,097,152
//    updates.  A heavy slab is summed by a whole block first, one contiguous
//    piece of its sorted range per warp; a run cut by the pieces' edges is
//    finished by the warp that holds its head, which adds the next warps'
//    partial sums in warp order.  No run is summed by one thread alone.
// Every sum is taken in an order fixed by the sorted ids alone, so the
// result is bitwise identical from run to run; the only atomics count (the
// slab counter and the heavy list), so which warp builds a slab may change
// but not what it writes.  Every output element is written by this kernel,
// so the output needs no zero fill beforehand.  Ids outside [0, num_rows)
// fall in no slab and are dropped, as XLA's scatter drops them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;      // slabs a warp takes from the counter at once
constexpr int kRounds = 4;      // lanes-are-updates: rounds of 32 in flight
constexpr int kInFlight = 16;   // lanes-are-columns: updates' loads in flight
constexpr unsigned kAll = 0xffffffffu;

// Scratch (int32), made by the caller: starts[num_slabs + 1], then
// heavy[num_slabs], then the heavy count and the slab counter.
struct Scratch {
  int32_t* starts;
  int32_t* heavy;
  int32_t* counters;
};

__host__ __device__ inline Scratch split_scratch(void* p, int num_slabs) {
  int32_t* s = static_cast<int32_t*>(p);
  return {s, s + num_slabs + 1, s + 2 * num_slabs + 1};
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

// lists the slabs with more than `limit` updates (in no particular order:
// each is built the same way whichever block takes it)
__global__ void __launch_bounds__(256) scatter_heavy_slabs_kernel(
    int num_slabs, int limit, Scratch scratch) {
  const int s = blockIdx.x * 256 + threadIdx.x;
  if (s < num_slabs &&
      scratch.starts[s + 1] - scratch.starts[s] > limit) {
    scratch.heavy[atomicAdd(scratch.counters, 1)] = s;
  }
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
  const int64_t* perm;
  const void* vals;
  float* out;
  Scratch scratch;
  int64_t num_rows;
  int d, slab_rows, num_slabs, pitch, acc_floats, heavy_limit;
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
  // the slab from acc, or, when acc is null, this slab and the next n - 1
  // as zeros; by thread t of nt (a multiple of 32), a transposed slab 4
  // columns per warp at a time
  __device__ void write(const float* acc, int n, int t, int nt) const {
    const int64_t all = row0 + static_cast<int64_t>(n) * rows < num_rows
                            ? static_cast<int64_t>(n) * rows
                            : num_rows - row0;
    if (!transposed) {
      put_range<true>(out + row0 * d, acc ? acc + off : nullptr,
                      static_cast<int>(all * d), t, nt);
      return;
    }
    for (int c = t >> 3; c < d; c += nt >> 3) {
      put_range<false>(out + c * num_rows + row0,
                       acc ? acc + c * pitch : nullptr,
                       static_cast<int>(all), t & 7, 8);
    }
  }
};

// the row's first min(d, 4) columns into v, zeros past them
__device__ __forceinline__ void load4(const float* p, int d, bool vec,
                                      float (&v)[4]) {
  if (vec) {  // d == 4, 16-byte aligned rows
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = c < d ? __ldg(p + c) : 0.0f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int d, bool,
                                      float (&v)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = c < d ? __bfloat162float(p[c]) : 0.0f;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// A warp's piece [lo, hi) of a slab's sorted range [start, end): the sums of
// its runs go into the slab, except that of a run that began before lo,
// which goes into the warp's carry line (*through: that run also goes on
// past hi).  Returns the slab row of a run that began in the piece and goes
// on past hi, else -1.
//
// Up to d=4, lanes are updates; each round adds its runs' sums to what the
// slab (or carry) holds, so a run met by several rounds adds up in order.
template <typename V>
__device__ int sum_by_updates(const Params& p, const Slab& slab, int lo,
                              int hi, int start, int end, float* acc,
                              float* carry, int* through, int lane) {
  const V* vals = static_cast<const V*>(p.vals);
  const int first = p.ids[lo];
  const bool left_open = lo > start && p.ids[lo - 1] == first;
  if (left_open && lane < 4) carry[lane] = 0.0f;
  __syncwarp();
  for (int j0 = lo; j0 < hi; j0 += 32 * kRounds) {
    int id[kRounds];
    float x[kRounds][4];
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int j = j0 + 32 * q + lane;
      if (j < hi) {
        id[q] = p.ids[j];
        load4(vals + p.perm[j] * p.d, p.d, p.vec, x[q]);
      } else {  // an id no valid lane has
        id[q] = -1 - lane;
        x[q][0] = x[q][1] = x[q][2] = x[q][3] = 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      if (j0 + 32 * q >= hi) break;
      // segmented inclusive sum over the lanes, in a fixed tree order: the
      // ids are sorted, so equal ids `off` lanes apart bound one run
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kAll, id[q], off);
        float y[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = __shfl_up_sync(kAll, x[q][c], off);
        if (lane >= off && up == id[q]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) x[q][c] += y[c];
        }
      }
      const int next = __shfl_down_sync(kAll, id[q], 1);
      if (j0 + 32 * q + lane < hi && (lane == 31 || next != id[q])) {
        const bool to_carry = left_open && id[q] == first;
        const int r = static_cast<int>(id[q] - slab.row0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < p.d) {
            (to_carry ? carry[c] : acc[slab.slot(r, c)]) += x[q][c];
          }
        }
      }
      __syncwarp();
    }
  }
  const int last = p.ids[hi - 1];
  const bool right_open = hi < end && p.ids[hi] == last;
  if (left_open && lane == 0) *through = right_open && last == first;
  return right_open && !(left_open && last == first)
             ? static_cast<int>(last - slab.row0)
             : -1;
}

// Above d=4, lanes are columns c0 + lane.  Each lane sums its column of
// each run in sorted order and stores it once into acc (or carry).
template <typename V>
__device__ int sum_by_columns(const Params& p, const Slab& slab, int c0,
                              int lo, int hi, int start, int end, float* acc,
                              float* carry, int* through, int lane) {
  const V* vals = static_cast<const V*>(p.vals);
  const int c = c0 + lane;
  const bool col = c < p.d;
  const int first = p.ids[lo];
  const bool left_open = lo > start && p.ids[lo - 1] == first;
  int cur = first;
  float s = 0.0f;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const int my_id = j < hi ? p.ids[j] : 0;
    const int64_t my_row = j < hi ? p.perm[j] : 0;
    const int nb = min(32, hi - j0);
    for (int b0 = 0; b0 < nb; b0 += kInFlight) {
      int idb[kInFlight];
      float v[kInFlight];
#pragma unroll
      for (int b = 0; b < kInFlight; ++b) {
        idb[b] = __shfl_sync(kAll, my_id, b0 + b);
        const int64_t row = __shfl_sync(kAll, my_row, b0 + b);
        v[b] = b0 + b < nb && col ? load1(vals + row * p.d + c) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < kInFlight; ++b) {
        if (b0 + b < nb) {
          if (idb[b] != cur) {
            if (col) {
              if (left_open && cur == first) {
                carry[lane] = s;
              } else {
                acc[slab.slot(static_cast<int>(cur - slab.row0), c)] = s;
              }
            }
            cur = idb[b];
            s = 0.0f;
          }
          s += v[b];
        }
      }
    }
  }
  const bool right_open = hi < end && p.ids[hi] == cur;
  const bool in_carry = left_open && cur == first;
  if (col) {
    if (in_carry) {
      carry[lane] = s;
    } else {
      acc[slab.slot(static_cast<int>(cur - slab.row0), c)] = s;
    }
  }
  if (left_open && lane == 0) *through = right_open && in_carry;
  return right_open && !in_carry ? static_cast<int>(cur - slab.row0) : -1;
}

template <typename V>
__device__ __forceinline__ int sum_piece(const Params& p, const Slab& slab,
                                         int c0, int lo, int hi, int start,
                                         int end, float* acc, float* carry,
                                         int* through, int lane) {
  if (lo >= hi) return -1;
  return p.d <= 4 ? sum_by_updates<V>(p, slab, lo, hi, start, end, acc,
                                      carry, through, lane)
                  : sum_by_columns<V>(p, slab, c0, lo, hi, start, end, acc,
                                      carry, through, lane);
}

__device__ __forceinline__ void zero(float* acc, int n4, int t, int nt) {
  for (int k = t; k < n4; k += nt) {
    reinterpret_cast<float4*>(acc)[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) scatter_add_rows_kernel(
    Params p) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* accs = reinterpret_cast<float*>(smem);   // kWarps slabs
  float* carry = accs + kWarps * p.acc_floats;    // [kWarps][32]
  int* through = reinterpret_cast<int*>(carry + kWarps * 32);
  const int32_t* starts = p.scratch.starts;
  const int col_step = p.d <= 4 ? p.d : 32;

  // 1. heavy slabs, a block each: one piece per warp, carried in warp order
  const int n_heavy = p.scratch.counters[0];
  for (int k = blockIdx.x; k < n_heavy; k += gridDim.x) {
    const int s = p.scratch.heavy[k];
    const Slab slab(p, s);
    const int start = starts[s], end = starts[s + 1];
    zero(accs, p.acc_floats / 4, threadIdx.x, kThreads);
    __syncthreads();
    const int n_s = end - start;
    const int per = (n_s + kWarps - 1) / kWarps;
    const int lo = start + min(n_s, warp * per);
    const int hi = min(lo + per, end);
    for (int c0 = 0; c0 < p.d; c0 += col_step) {
      const int owned = sum_piece<V>(p, slab, c0, lo, hi, start, end, accs,
                                     carry + 32 * warp, through + warp, lane);
      __syncwarp();
      if (__syncthreads_or(owned >= 0)) {
        const int c = c0 + lane;
        if (owned >= 0 && c < p.d && lane < col_step) {
          for (int w = warp + 1; w < kWarps; ++w) {  // in warp order
            accs[slab.slot(owned, c)] += carry[32 * w + lane];
            if (!through[w]) break;
          }
        }
        __syncthreads();
      }
    }
    slab.write(accs, 1, threadIdx.x, kThreads);
    __syncthreads();
  }

  // 2. every other slab, a warp each, taken kChunk at a time; a run of
  // empty slabs is written as one stretch of zeros
  float* acc = accs + warp * p.acc_floats;
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
      const Slab slab(p, base + q);
      if (empty >> q & 1) {
        const int run = min(count - q, __ffs(~(empty >> q)) - 1);
        slab.write(nullptr, run, lane, 32);
        q += run;
        continue;
      }
      const int start = __shfl_sync(kAll, my_start, q);
      const int end = __shfl_sync(kAll, my_start, q + 1);
      ++q;
      if (end - start > p.heavy_limit) continue;  // built in step 1
      zero(acc, p.acc_floats / 4, lane, 32);
      __syncwarp();
      for (int c0 = 0; c0 < p.d; c0 += col_step) {
        sum_piece<V>(p, slab, c0, start, end, start, end, acc, nullptr,
                     nullptr, lane);
        __syncwarp();
      }
      slab.write(acc, 1, lane, 32);
      __syncwarp();
    }
  }
}

template <typename V>
int launch(Params p, cudaStream_t stream) {
  const int64_t smem = 4 * (static_cast<int64_t>(kWarps) * p.acc_floats +
                            kWarps * 32 + kWarps);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = scatter_add_rows_kernel<V>;
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
  scatter_heavy_slabs_kernel<<<(p.num_slabs + 255) / 256, 256, 0, stream>>>(
      p.num_slabs, p.heavy_limit, p.scratch);
  kernel<<<sms * per_sm, kThreads, static_cast<size_t>(smem), stream>>>(p);
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

}  // namespace

// ids: (n,) int32 sorted ascending; scratch: 2 * num_slabs + 3 int32, where
// num_slabs = ceil(num_rows / slab_rows); writes each slab's first sorted
// position (scratch[0, num_slabs]) and zeroes the counters the main kernel
// uses.  Returns cudaErrorInvalidValue for arguments out of range, else the
// launch's cudaGetLastError().
extern "C" int scatter_slab_starts(const void* ids, long long n,
                                   long long num_rows, int slab_rows,
                                   void* scratch, void* stream) {
  if (bad_shape(n, num_rows, slab_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int num_slabs = num_slabs_of(num_rows, slab_rows);
  const int blocks = static_cast<int>((n + 1 + 255) / 256);
  scatter_slab_starts_kernel<<<blocks, 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int>(n), num_rows,
      slab_rows, num_slabs, split_scratch(scratch, num_slabs));
  return static_cast<int>(cudaGetLastError());
}

// ids: (n,) int32 sorted ascending; perm: (n,) int64, the sort's permutation
// (ids[i] is the id of vals row perm[i]); vals: (n, d) f32 (bf16 = 0) or
// bf16 (bf16 = 1), contiguous, in input order; scratch: as the pre-pass left
// it; out: (num_rows, d) f32, or (d, num_rows) when transposed; every
// element of out is written.  heavy_limit: a slab with more updates is
// summed by a whole block.  All pointers are device pointers; stream is a
// cudaStream_t.  Needs 1 <= d <= 1024 and 16 slabs in shared memory.
// Returns cudaErrorInvalidValue for arguments out of range, else the
// launch's cudaGetLastError().
extern "C" int scatter_add_rows(const void* ids, const void* perm,
                                const void* vals, int bf16, void* scratch,
                                void* out, long long n, int d,
                                long long num_rows, int slab_rows,
                                int transposed, int heavy_limit,
                                void* stream) {
  if (bad_shape(n, num_rows, slab_rows) || d < 1 || d > 1024 ||
      heavy_limit < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.ids = static_cast<const int32_t*>(ids);
  p.perm = static_cast<const int64_t*>(perm);
  p.vals = vals;
  p.out = static_cast<float*>(out);
  p.num_rows = num_rows;
  p.d = d;
  p.slab_rows = slab_rows;
  p.num_slabs = num_slabs_of(num_rows, slab_rows);
  p.scratch = split_scratch(scratch, p.num_slabs);
  p.transposed = transposed != 0;
  // an odd pitch: 32 lanes writing one row of 32 columns hit 32 banks
  p.pitch = slab_rows | 1;
  p.acc_floats = ((p.transposed ? d * p.pitch : slab_rows * d + 3) + 3) & ~3;
  p.heavy_limit = heavy_limit;
  p.vec = !bf16 && d == 4 && (reinterpret_cast<uintptr_t>(vals) & 15) == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
