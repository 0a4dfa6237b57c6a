// Row gather with a burst detector, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/burst_gather.py, `burst_gather` (the Pallas
// `_kernel`, pallas_call at :75), the TPU form of TAPA's async_mmap burst
// detector.  Semantics are those of repro_torch/kernels/ref.py::
// burst_gather_ref: out[i] = table[idx[i]], for indices in [0, R).
//
// What bounds it on an H100: it does no arithmetic, so bytes alone: each
// gathered row is read once and written once.  At granite-8b's prefill
// (2048 ids into a (49152, 4096) bf16 table) that is ~33.5 MB, ~10 us at
// 3.35 TB/s; at granite-moe's prefill dispatch (16,384 ids into the
// (2048, 1536) bf16 activations) ~57 MB, ~17 us.  A copy is latency-bound
// unless each SM keeps tens of KB in flight.
//
// What the design does about it: a warp a row, WARPS rows a block.  Each
// lane issues all its loads of the row (UNROLL vectors of 16 bytes, 8 KB a
// warp; longer rows take more rounds) before it stores any, so a whole
// row is in flight at once and an SM holds up to 64 warps of rows.  Stores
// stream past L1 and are the first out of L2 (st.global.cs), which keeps
// the table's rows in L2: the MoE dispatch reads each row 8 times.
// Narrower vectors where the row size or pointers are not 16-byte aligned.
// This beat Hopper bulk copies (cp.async.bulk through a ring of tiles in
// shared memory) at the served shapes (PERF.md), so it is the only path.
//
// The burst detector, as in the TPU kernel: ids come in tiles of IB = 8,
// and a tile whose ids are one run of in-range rows (idx[i] == idx[0] + i)
// is a burst.  A warp's copy of a row is already one contiguous range, so
// a burst is copied as any other tile is; when `bursts` is not null, the
// first warp of each tile counts the tile if it is one.
//
// An index outside [0, R) is never read: its output row is written as
// zeros (the wrapper documents that indices must be in range).
//
// The backward (burst_gather_bwd): dtable = a zero (R, D) table with each
// row of dout added into row idx[i], the table gradient of the gather.
// Ids repeat heavily (a token embedding: the commonest token is ~1/7 of a
// Zipfian batch), and it must give the same bits on every run, so it takes
// no float atomics: each taken row is one sequential f32 sum over its
// positions in increasing order, rounded once, the same adds as a
// sequential f32 index_add.  Two kernels on the stream:
//  * bwd_sort, one block: CUB's block radix sort (a stable sort inside this
//    kernel) of the rows of up to SORT_MAX ids with their positions, so
//    each row's positions come out in order; the taken rows' segments from
//    the row changes (a block scan), in classes of count, most-taken
//    first; a bitmap of the taken rows.  No R-wide pass but the bitmap's
//    R / 32 words.
//  * bwd_write, three blocks of 8 warps an SM, every warp taking items off
//    a counter.  Four warps of a block sum the taken rows, most-taken row
//    first, from a ring of 16 rows in flight a lane (cp.async), and write
//    each once: a row taken 32 times or more as 512-byte column slices, so
//    that its chain is split over 16 warps; a lighter row as one item that
//    streams all its slices.  The other four then stream zeros over the
//    untaken rows, in runs of 32 KB, with the summing warps once no item
//    is left.  The zeros wait for the sums: run together (measured on an
//    H100), the dependent chain of the commonest row (606 adds at
//    granite-8b's training batch) slowed behind the saturated writes more
//    than the overlap saved.
// What bounds it: bytes, and mostly the zero table: the 403 MB (49152,
// 4096) bf16 gradient of granite-8b's embedding against 34 MB of dout,
// ~0.13 ms at 3.35 TB/s.  The sort (~14 us, one SM) comes before it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

#include "hopper.cuh"

namespace {

constexpr int IB = 8;
constexpr int WARPS = 4;  // rows (warps) of a block
constexpr int UNROLL = 16;
static_assert(IB % WARPS == 0, "a tile starts at a block's first row");

// Whether the tile of ids from t0 is one run of in-range rows; the caller
// is a whole warp.
__device__ __forceinline__ bool is_burst(const int* __restrict__ idx,
                                         long long t0, long long N,
                                         long long R) {
  const int lane = threadIdx.x & 31;
  const int n = (int)(N - t0 < IB ? N - t0 : IB);
  const long long row = lane < n ? idx[t0 + lane] : 0;
  const long long first = __shfl_sync(0xffffffffu, row, 0);
  return __all_sync(0xffffffffu, lane >= n || (row >= 0 && row < R &&
                                               row == first + lane));
}

template <typename V>
__global__ void __launch_bounds__(32 * WARPS)
burst_vec(const char* table, const int* __restrict__ idx, char* out,
          long long R, long long N, long long row_bytes, int* bursts) {
  // table and out are not __restrict__: with it the compiler may move each
  // store up among the loads, and it did, leaving two or three of a lane's
  // loads in flight instead of all UNROLL
  const int lane = threadIdx.x & 31;
  // this warp's row of out
  const long long i = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bursts && i % IB == 0 && i < N && is_burst(idx, i, N, R) && lane == 0)
    atomicAdd(bursts, 1);
  if (i >= N) return;
  const long long row = idx[i];
  const bool in = row >= 0 && row < R;
  const long long vpr = row_bytes / (long long)sizeof(V);
  const V* src = reinterpret_cast<const V*>(table + row * row_bytes);
  V* dst = reinterpret_cast<V*>(out + i * row_bytes);
  for (long long base = lane; base < vpr; base += 32 * UNROLL) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = base + 32 * u;
      v[u] = in && j < vpr ? src[j] : V{};
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = base + 32 * u;
      if (j < vpr) __stcs(dst + j, v[u]);
    }
  }
}

template <typename V>
int launch(const void* table, const int* idx, void* out, long long R,
           long long N, long long row_bytes, int* bursts,
           cudaStream_t stream) {
  burst_vec<V><<<(unsigned)((N + WARPS - 1) / WARPS), 32 * WARPS, 0,
                 stream>>>(static_cast<const char*>(table), idx,
                           static_cast<char*>(out), R, N, row_bytes, bursts);
  return (int)cudaGetLastError();
}

}  // namespace

// table: (R, row_bytes) bytes; idx: (N,) int32 on the device; out:
// (N, row_bytes); bursts: an int on the device that gains the number of
// tiles of IB ids that were one run of rows, or null.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int burst_gather_fwd(const void* table, const int* idx, void* out,
                                long long R, long long N, long long row_bytes,
                                int* bursts, void* stream) {
  if (N == 0 || row_bytes == 0) return 0;
  if ((N + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch<uint4>(table, idx, out, R, N, row_bytes, bursts, s);
  if (align % 8 == 0)
    return launch<uint2>(table, idx, out, R, N, row_bytes, bursts, s);
  if (align % 4 == 0)
    return launch<unsigned>(table, idx, out, R, N, row_bytes, bursts, s);
  if (align % 2 == 0)
    return launch<unsigned short>(table, idx, out, R, N, row_bytes, bursts,
                                  s);
  return launch<unsigned char>(table, idx, out, R, N, row_bytes, bursts, s);
}

// ------------------------------------------------------------- backward

namespace {

constexpr int SORT_T = 1024;       // threads of the sort
constexpr int SORT_MAX = 16384;    // ids one block sorts: 16 a thread
constexpr int WW = 8;              // warps of a writer block
constexpr int SW = 4;              // of them, the warps that sum
constexpr int RING = 16;           // rows in flight a summing warp
constexpr int GR = 2;              // rows a cp.async group
constexpr int SLICE = 512;         // bytes of a row slice: 16 a lane
constexpr int SU = 16;             // loads in flight a lane, unaligned rows
constexpr int ZERO_BYTES = 32768;  // table bytes of a zeroing item
constexpr int WRITE_BLOCKS = 3;    // writer blocks an SM
constexpr int HEAVY = 5;           // count classes from 2^5 up: a row taken
                                   // that often is summed slice by slice

// An exclusive scan within the block of one value a thread; `sums` holds
// SORT_T / 32 ints of shared memory.  Returns this thread's exclusive
// prefix; `total` gets the block's sum.
__device__ inline int block_scan(int x, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  __syncthreads();  // sums may be read by an earlier call
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int y = sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, off);
      if (lane >= off) y += z;
    }
    sums[lane] = y;
  }
  __syncthreads();
  *total = sums[SORT_T / 32 - 1];
  return inc - x + (warp > 0 ? sums[warp - 1] : 0);
}

template <int ITEMS>
using RowSort = cub::BlockRadixSort<unsigned, SORT_T, ITEMS, int>;

template <int ITEMS>
constexpr size_t sort_smem() {
  constexpr size_t lists = 8 * (size_t)SORT_T * ITEMS;  // keys, first[]
  constexpr size_t temp = sizeof(typename RowSort<ITEMS>::TempStorage);
  return temp > lists ? temp : lists;
}

// One block, ITEMS ids a thread.  A stable radix sort of the ids' rows
// (CUB's block-level sort; an id outside [0, R), and the padding, as row
// R, over the end_bit bits that hold R) with their positions as values, so
// each row's positions come out in increasing order: perm[j] = the
// position of sorted id j.  Then the taken rows' segments of perm, segs[t]
// = (row, first, count, 0), in classes of count (floor(log2)) from the
// largest down: the writer takes the most-taken rows first (the order
// within a class varies from run to run and changes no bit of the result).
// Also the bitmap of taken rows and the writer's state: state[0] = the
// number of segments, state[1] = state[2] = 0, its two work counters,
// state[3] = the segments of rows taken 2^HEAVY times or more, which come
// first, and state[4] = 0, the summing items done.
template <int ITEMS>
__global__ void __launch_bounds__(SORT_T)
bwd_sort(const int* __restrict__ idx, int N, int R, int end_bit,
         int* __restrict__ perm, int4* __restrict__ segs,
         unsigned* __restrict__ taken, int* __restrict__ state) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int sums[SORT_T / 32];
  __shared__ int class_n[16], class_at[16];
  for (int w = threadIdx.x; w < (R + 31) / 32; w += SORT_T) taken[w] = 0u;
  if (threadIdx.x < 16) class_n[threadIdx.x] = 0;
  unsigned key[ITEMS];
  int pos[ITEMS];
  const int b0 = threadIdx.x * ITEMS;  // this thread's sorted ids, after
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int r = b0 + k < N ? idx[b0 + k] : -1;
    key[k] = r >= 0 && r < R ? (unsigned)r : (unsigned)R;
    pos[k] = b0 + k;
  }
  RowSort<ITEMS>(*reinterpret_cast<typename RowSort<ITEMS>::TempStorage*>(
                     sm))
      .Sort(key, pos, 0, end_bit);
  __syncthreads();  // the sort's storage is free
  unsigned* skey = reinterpret_cast<unsigned*>(sm);  // sorted rows
  int* first = reinterpret_cast<int*>(skey + SORT_T * ITEMS);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) skey[b0 + k] = key[k];
  __syncthreads();
  // a segment starts where the row changes, among the rows below R
  auto starts = [&](int k) {
    const int i = b0 + k;
    return i < N && key[k] < (unsigned)R && (i == 0 || skey[i - 1] != key[k]);
  };
  int n_start = 0, n_in = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (b0 + k < N) perm[b0 + k] = pos[k];
    n_start += starts(k);
    n_in += b0 + k < N && key[k] < (unsigned)R;
  }
  int n_seg, n_valid;
  int j = block_scan(n_start, sums, &n_seg);
  block_scan(n_in, sums, &n_valid);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (starts(k)) {
      first[j++] = b0 + k;
      atomicOr(taken + key[k] / 32, 1u << (key[k] % 32));
    }
  __syncthreads();
  auto count = [&](int t) {
    return (t + 1 < n_seg ? first[t + 1] : n_valid) - first[t];
  };
  for (int t = threadIdx.x; t < n_seg; t += SORT_T)
    atomicAdd(&class_n[31 - __clz(count(t))], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0, heavy = 0;
    for (int c = 15; c >= 0; --c) {
      class_at[c] = at;
      at += class_n[c];
      if (c >= HEAVY) heavy = at;  // the segments of classes from HEAVY up
    }
    state[0] = n_seg;
    state[1] = state[2] = state[4] = 0;
    state[3] = heavy;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_seg; t += SORT_T) {
    const int cnt = count(t);
    const int slot = atomicAdd(&class_at[31 - __clz(cnt)], 1);
    segs[slot] = make_int4((int)skey[first[t]], first[t], cnt, 0);
  }
}

__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }
__device__ inline void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ inline void from_f32(float* p, float x) { *p = x; }

// 16 bytes of T added into V = 16 / sizeof(T) f32 sums
__device__ inline void add16(float* acc, uint4 u, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    acc[2 * e] += f.x;
    acc[2 * e + 1] += f.y;
  }
}
__device__ inline void add16(float* acc, uint4 u, const float*) {
  acc[0] += __uint_as_float(u.x);
  acc[1] += __uint_as_float(u.y);
  acc[2] += __uint_as_float(u.z);
  acc[3] += __uint_as_float(u.w);
}
__device__ inline uint4 narrow16(const float* x, const __nv_bfloat16*) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    w[e] = *reinterpret_cast<const unsigned*>(&h);
  }
  return u;
}
__device__ inline uint4 narrow16(const float* x, const float*) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}

// One warp: the slice [c0, c0 + 32 V) of a taken row (lane: columns c0 +
// V lane), the sum of the n dout rows at positions pos[0..n) in that
// order, in f32 from 0, rounded once.  Each lane copies its 16 bytes of
// each row into its own slots of a ring of RING rows (cp.async, GR rows a
// commit group, RING / GR groups in flight) and reads back only its own
// copies, so the lanes never wait on each other.  The positions come 32 at
// a time, a chunk ahead, broadcast by shuffles.
template <typename T>
__device__ inline void sum_vec(const T* __restrict__ dout,
                               const int* __restrict__ pos, int n,
                               T* __restrict__ row, int D, int c0,
                               uint4* ring, int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NG = RING / GR;
  const int c = c0 + lane * V;
  const bool on = c < D;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  int pc = lane < n ? pos[lane] : 0;            // positions [t0, t0 + 32)
  int pn = 32 + lane < n ? pos[32 + lane] : 0;  // the next 32
  int next = 0;                                 // the next row to copy
  auto issue_group = [&]() {
#pragma unroll
    for (int u = 0; u < GR; ++u, ++next) {
      if (next > 0 && (next & 31) == 0) {
        pc = pn;
        pn = next + 32 + lane < n ? pos[next + 32 + lane] : 0;
      }
      const int r = __shfl_sync(0xffffffffu, pc, next & 31);
      if (on && next < n)
        cp_async16(ring + (next % RING) * 32, dout + (long long)r * D + c,
                   16);
    }
    cp_async_commit();  // one group every GR rows, empty past n
  };
  for (int g = 0; g < NG - 1; ++g) issue_group();
  for (int t0 = 0; t0 < n; t0 += GR) {
    issue_group();
    cp_async_wait<NG - 1>();  // this lane's copies of rows t0.. landed
#pragma unroll
    for (int u = 0; u < GR; ++u)
      if (on && t0 + u < n) add16(acc, ring[((t0 + u) % RING) * 32], dout);
  }
  cp_async_wait<0>();  // no copy left in flight into the ring
  if (on) *reinterpret_cast<uint4*>(row + c) = narrow16(acc, dout);
}

// One warp: every slice of a row taken n < 32 times, slice by slice, each
// the sum of its n rows in position order in f32 from 0, rounded once.
// The (slice, row) copies stream through the same ring without a break
// between slices, so a lightly taken row costs one fill of the ring, not
// one a slice; the n positions are one load.
template <typename T>
__device__ inline void sum_light(const T* __restrict__ dout,
                                 const int* __restrict__ pos, int n,
                                 T* __restrict__ row, int D, int slices,
                                 uint4* ring, int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NG = RING / GR;
  const int pc = lane < n ? pos[lane] : 0;
  const int total = n * slices;
  int next = 0, isl = 0, ij = 0;  // the next copy: its slice and row
  auto issue_group = [&]() {
#pragma unroll
    for (int u = 0; u < GR; ++u, ++next) {
      if (next < total) {
        const int r = __shfl_sync(0xffffffffu, pc, ij);
        const int c = isl * 32 * V + lane * V;
        if (c < D)
          cp_async16(ring + (next % RING) * 32, dout + (long long)r * D + c,
                     16);
        if (++ij == n) {
          ij = 0;
          ++isl;
        }
      }
    }
    cp_async_commit();
  };
  for (int g = 0; g < NG - 1; ++g) issue_group();
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  int sl = 0, j = 0;  // the copy read next: its slice and row
  for (int t0 = 0; t0 < total; t0 += GR) {
    issue_group();
    cp_async_wait<NG - 1>();
#pragma unroll
    for (int u = 0; u < GR; ++u) {
      if (t0 + u >= total) break;
      const int c = sl * 32 * V + lane * V;
      if (c < D) add16(acc, ring[((t0 + u) % RING) * 32], dout);
      if (++j == n) {  // the slice is summed
        if (c < D) *reinterpret_cast<uint4*>(row + c) = narrow16(acc, dout);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
        j = 0;
        ++sl;
      }
    }
  }
  cp_async_wait<0>();
}

// The same for rows not 16-byte aligned: one column a lane, SU loads in
// flight
template <typename T>
__device__ inline void sum_scalar(const T* __restrict__ dout,
                                  const int* __restrict__ pos, int n,
                                  T* __restrict__ row, int D, int c) {
  if (c >= D) return;
  float acc = 0.f;
  int p = 0;
  for (; p + SU <= n; p += SU) {
    float x[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u)
      x[u] = to_f32(dout[(long long)pos[p + u] * D + c]);
#pragma unroll
    for (int u = 0; u < SU; ++u) acc += x[u];
  }
  for (; p < n; ++p) acc += to_f32(dout[(long long)pos[p] * D + c]);
  from_f32(row + c, acc);
}

// The next item of a work counter, for the whole warp
__device__ inline int take(int* counter, int lane) {
  int item = 0;
  if (lane == 0) item = atomicAdd(counter, 1);
  return __shfl_sync(0xffffffffu, item, 0);
}

// The writer.  Two queues, each a counter: the taken rows (state[1]), in
// segs' order, most-taken rows first, a row taken 2^HEAVY times or more as
// one item a column slice (SLICE bytes), the others as one item for the
// whole row (and every row as 32-column slices where rows are not 16-byte
// aligned); and runs of zr table rows (state[2]), written as zeros
// (streaming stores, first out of L2) but for the taken ones.  The first
// SW warps of a block sum, each with its ring, counting the items done in
// state[4], and zero once no item is left; the other warps zero once every
// item is done.
template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * WW)
bwd_write(const T* __restrict__ dout, const int* __restrict__ perm,
          const int4* __restrict__ segs, int* __restrict__ state,
          const unsigned* __restrict__ taken, T* __restrict__ dtable, int R,
          int D, int slices, int zr) {
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  extern __shared__ uint4 rings[];  // [SW][RING][32] when VEC
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < SW) {
    uint4* ring = rings + warp * RING * 32 + lane;
    // with aligned rows, a lightly taken row is one item for all its slices
    const int split = VEC ? state[3] : state[0];
    const int n_split = split * slices;
    const int n_sum = n_split + state[0] - split;
    for (int item; (item = take(state + 1, lane)) < n_sum;) {
      const int4 sg = segs[item < n_split ? item / slices
                                          : split + item - n_split];
      T* row = dtable + (long long)sg.x * D;  // sg: (row, first, count)
      if constexpr (VEC) {
        if (item < n_split)
          sum_vec<T>(dout, perm + sg.y, sg.z, row, D,
                     (item % slices) * 32 * V, ring, lane);
        else
          sum_light<T>(dout, perm + sg.y, sg.z, row, D, slices, ring, lane);
      } else {
        sum_scalar<T>(dout, perm + sg.y, sg.z, row, D,
                      (item % slices) * 32 + lane);
      }
      if (lane == 0) atomicAdd(state + 4, 1);  // one more item summed
    }
  } else {
    // the zeros wait for the sums: the sums' dependent reads slow down
    // behind a memory system saturated by writes, and took longer than
    // the zeros did
    const int n_sum = VEC ? state[3] * slices + state[0] - state[3]
                          : state[0] * slices;
    while (*(volatile int*)(state + 4) < n_sum) __nanosleep(500);
  }
  const int n_zero = (R + zr - 1) / zr;
  for (int item; (item = take(state + 2, lane)) < n_zero;) {
    const int r1 = min(R, (item + 1) * zr);
    for (int r = item * zr; r < r1; ++r) {
      if ((taken[r >> 5] >> (r & 31)) & 1u) continue;
      T* row = dtable + (long long)r * D;
      if constexpr (VEC) {
#pragma unroll 4
        for (int c = lane * V; c < D; c += 32 * V)
          __stcs(reinterpret_cast<uint4*>(row + c), make_uint4(0u, 0u, 0u, 0u));
      } else {
        for (int c = lane; c < D; c += 32) from_f32(row + c, 0.f);
      }
    }
  }
}

template <int ITEMS>
int launch_sort(const int* idx, int N, int R, int* perm, int4* segs,
                unsigned* taken, int* state, cudaStream_t s) {
  constexpr size_t smem = sort_smem<ITEMS>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_sort<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int end_bit = 32 - __builtin_clz((unsigned)R);  // R itself fits
  bwd_sort<ITEMS><<<1, SORT_T, smem, s>>>(idx, N, R, end_bit, perm, segs,
                                           taken, state);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* dout, const int* idx, void* dtable, int R, int N,
               int D, int* scratch, int n_sm, cudaStream_t s) {
  constexpr size_t ring_bytes = (size_t)SW * RING * SLICE;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_write<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ring_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int slots = min(N, R);  // segments there can be
  int4* segs = reinterpret_cast<int4*>(scratch);
  int* perm = scratch + 4 * slots;
  unsigned* taken = reinterpret_cast<unsigned*>(perm + N);
  int* state = reinterpret_cast<int*>(taken + (R + 31) / 32);
  // ITEMS = ids a thread: B (S + 1) ids of a power-of-two S sit just above
  // a power of two, hence 5
  int e;
  if (N <= SORT_T)
    e = launch_sort<1>(idx, N, R, perm, segs, taken, state, s);
  else if (N <= 2 * SORT_T)
    e = launch_sort<2>(idx, N, R, perm, segs, taken, state, s);
  else if (N <= 4 * SORT_T)
    e = launch_sort<4>(idx, N, R, perm, segs, taken, state, s);
  else if (N <= 5 * SORT_T)
    e = launch_sort<5>(idx, N, R, perm, segs, taken, state, s);
  else if (N <= 8 * SORT_T)
    e = launch_sort<8>(idx, N, R, perm, segs, taken, state, s);
  else
    e = launch_sort<16>(idx, N, R, perm, segs, taken, state, s);
  if (e != 0) return e;
  constexpr int V = 16 / sizeof(T);
  const size_t row_bytes = sizeof(T) * (size_t)D;
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dout) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dtable) % 16 == 0;
  const int slices = vec ? (D + 32 * V - 1) / (32 * V) : (D + 31) / 32;
  const int zr = row_bytes < ZERO_BYTES ? (int)(ZERO_BYTES / row_bytes) : 1;
  const int blocks = WRITE_BLOCKS * n_sm;
  const T* src = static_cast<const T*>(dout);
  T* dst = static_cast<T*>(dtable);
  if (vec)
    bwd_write<T, true><<<blocks, 32 * WW, ring_bytes, s>>>(
        src, perm, segs, state, taken, dst, R, D, slices, zr);
  else
    bwd_write<T, false><<<blocks, 32 * WW, 0, s>>>(
        src, perm, segs, state, taken, dst, R, D, slices, zr);
  return (int)cudaGetLastError();
}

}  // namespace

// dout: (N, D) of dtype (0 = bfloat16, 1 = float32); idx: (N,) int32 on
// the device, N <= 16384 (SORT_MAX); dtable: (R, D) of the same dtype,
// every row written; scratch: 4 min(N, R) + N + ceil(R / 32) + 4 ints,
// 16-byte aligned; n_sm: the device's SMs.  Ids outside [0, R) add to no
// row.  Returns the CUDA error of the launches (0 on success).
extern "C" int burst_gather_bwd(const void* dout, const int* idx,
                                void* dtable, int R, int N, int D, int dtype,
                                int* scratch, int n_sm, void* stream) {
  if (R <= 0 || D <= 0 || N < 0 || N > SORT_MAX || n_sm <= 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(dout, idx, dtable, R, N, D, scratch,
                                     n_sm, s);
  if (dtype == 1)
    return launch_bwd<float>(dout, idx, dtable, R, N, D, scratch, n_sm, s);
  return (int)cudaErrorInvalidValue;
}
