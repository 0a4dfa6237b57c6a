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
// no float atomics: a stable counting sort of the ids, then a segmented
// sum over the rows they take.  On the stream:
//  * the table is zeroed (cudaMemsetAsync, at the copy engines' rate),
//    and so are the row counts;
//  * bwd_rank: each id's rank among the equal ids before it (a block's ids
//    against all ids up to its own, through shared memory: N^2 / 2 integer
//    compares, 8.4 M for the 4,100 ids of a B 4 x S 1024 batch) and the
//    count of each row (integer atomics, exact in any order);
//  * bwd_scan: one block's exclusive scan of the counts into row offsets,
//    and the list of rows some id takes, in row order;
//  * bwd_place: perm[offset[idx[i]] + rank[i]] = i, so each row's
//    positions lie in increasing order;
//  * bwd_sum: a warp per (taken row, 32 * 8 bytes of columns) sums that
//    row's dout rows in that order in f32, 16 loads in flight a lane, and
//    writes the row once in the table's dtype.  The sum is the same
//    sequence of f32 adds as a sequential f32 index_add.
// What bounds it: bytes, and mostly the zero table: the 403 MB (49152,
// 4096) bf16 gradient of granite-8b's embedding against 34 MB of dout,
// ~0.13 ms at 3.35 TB/s.  A row taken by many ids is a chain of dependent
// adds a lane: 606 repeats are ~38 rounds of 16 loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int RB = 256;     // threads of the rank and place kernels
constexpr int RT = 1024;    // ids of a shared-memory tile in bwd_rank
constexpr int ST = 1024;    // threads of the scan
constexpr int SU = 16;      // dout rows in flight a lane in bwd_sum
constexpr int SW = 4;       // warps (taken rows) of a bwd_sum block

__global__ void __launch_bounds__(RB)
bwd_rank(const int* __restrict__ idx, int N, int R, int* __restrict__ counts,
         int* __restrict__ rank) {
  __shared__ int tile[RT];
  const int i = (int)(blockIdx.x * RB + threadIdx.x);
  const int my = i < N ? idx[i] : -1;
  const int last = min(N, ((int)blockIdx.x + 1) * RB);  // ids it sees
  int r = 0;
  for (int j0 = 0; j0 < last; j0 += RT) {
    __syncthreads();
    for (int t = threadIdx.x; t < RT; t += RB)
      tile[t] = j0 + t < last ? idx[j0 + t] : -1;
    __syncthreads();
    const int n = min(RT, max(0, i - j0));  // the ids before i only
    for (int t = 0; t < n; ++t) r += tile[t] == my;
  }
  if (i < N) {
    rank[i] = r;
    if (my >= 0 && my < R) atomicAdd(counts + my, 1);
  }
}

// An exclusive scan within the block of one value a thread; `sums` holds
// ST / 32 ints of shared memory.  Returns this thread's exclusive prefix;
// `total` gets the block's sum.
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
  *total = sums[ST / 32 - 1];
  return inc - x + (warp > 0 ? sums[warp - 1] : 0);
}

// offsets[r] = counts[0] + ... + counts[r - 1] (offsets[R] the total);
// rows: the rows with a count, in row order; *n_rows: how many
__global__ void __launch_bounds__(ST)
bwd_scan(const int* __restrict__ counts, int* __restrict__ offsets, int R,
         int* __restrict__ rows, int* __restrict__ n_rows) {
  __shared__ int sums[ST / 32];
  const int per = (R + ST - 1) / ST;
  const int b = threadIdx.x * per;
  const int e = min(b + per, R);
  int s = 0, t = 0;
  for (int i = b; i < e; ++i) {
    const int c = counts[i];
    s += c;
    t += c > 0;
  }
  int total, taken;
  int off = block_scan(s, sums, &total);
  int at = block_scan(t, sums, &taken);
  for (int i = b; i < e; ++i) {
    const int c = counts[i];
    offsets[i] = off;
    off += c;
    if (c > 0) rows[at++] = i;
  }
  if (threadIdx.x == 0) {
    offsets[R] = total;
    *n_rows = taken;
  }
}

__global__ void __launch_bounds__(RB)
bwd_place(const int* __restrict__ idx, const int* __restrict__ rank,
          const int* __restrict__ offsets, int N, int R,
          int* __restrict__ perm) {
  const int i = (int)(blockIdx.x * RB + threadIdx.x);
  if (i >= N) return;
  const int row = idx[i];
  if (row >= 0 && row < R) perm[offsets[row] + rank[i]] = i;
}

// 8 bytes of T, widened to f32, and back (rounded to nearest even)
__device__ inline void widen(const __nv_bfloat16* p, float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ inline void widen(const float* p, float* x) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  x[0] = f.x; x[1] = f.y;
}
__device__ inline void narrow(__nv_bfloat16* p, const float* x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ inline void narrow(float* p, const float* x) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
// one element at a time, for rows not 8 bytes wide or aligned
__device__ inline void widen1(const __nv_bfloat16* p, float* x) {
  x[0] = __bfloat162float(*p);
}
__device__ inline void widen1(const float* p, float* x) { x[0] = *p; }
__device__ inline void narrow1(__nv_bfloat16* p, const float* x) {
  *p = __float2bfloat16_rn(x[0]);
}
__device__ inline void narrow1(float* p, const float* x) { *p = x[0]; }

// Warp w of block x: the taken row rows[x * SW + w]; blockIdx.y: a slice
// of 32 * V columns, V = 8 / sizeof(T) elements a lane (VEC), or 1.
template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * SW)
bwd_sum(const T* __restrict__ dout, const int* __restrict__ perm,
        const int* __restrict__ offsets, const int* __restrict__ rows,
        const int* __restrict__ n_rows, T* __restrict__ dtable, int D) {
  constexpr int V = VEC ? 8 / (int)sizeof(T) : 1;
  const int lane = threadIdx.x & 31;
  const int slot = (int)(blockIdx.x * SW + (threadIdx.x >> 5));
  const int c = (int)(blockIdx.y * 32 + lane) * V;
  if (slot >= *n_rows || c >= D) return;
  const long long r = rows[slot];
  const int beg = offsets[r], end = offsets[r + 1];
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  int p = beg;
  for (; p + SU <= end; p += SU) {
    float x[SU][V];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const T* src = dout + (long long)perm[p + u] * D + c;
      if constexpr (VEC) widen(src, x[u]); else widen1(src, x[u]);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += x[u][e];
  }
  for (; p < end; ++p) {
    float x[V];
    const T* src = dout + (long long)perm[p] * D + c;
    if constexpr (VEC) widen(src, x); else widen1(src, x);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += x[e];
  }
  T* dst = dtable + r * D + c;
  if constexpr (VEC) narrow(dst, acc); else narrow1(dst, acc);
}

template <typename T>
int launch_bwd(const void* dout, const int* idx, void* dtable, int R, int N,
               int D, int* scratch, cudaStream_t s) {
  const int slots = min(N, R);       // rows that can be taken
  int* counts = scratch;             // R
  int* offsets = counts + R;         // R + 1
  int* rank = offsets + R + 1;       // N
  int* perm = rank + N;              // N
  int* rows = perm + N;              // slots
  int* n_rows = rows + slots;        // 1
  cudaError_t e = cudaMemsetAsync(dtable, 0, sizeof(T) * (size_t)R * D, s);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)R, s);
  if (e != cudaSuccess || N == 0) return (int)e;
  const int nb = (N + RB - 1) / RB;
  bwd_rank<<<nb, RB, 0, s>>>(idx, N, R, counts, rank);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bwd_scan<<<1, ST, 0, s>>>(counts, offsets, R, rows, n_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bwd_place<<<nb, RB, 0, s>>>(idx, rank, offsets, N, R, perm);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  constexpr int V = 8 / sizeof(T);
  const bool vec = D % V == 0 && reinterpret_cast<uintptr_t>(dout) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(dtable) % 8 == 0;
  const int w = vec ? 32 * V : 32;
  const dim3 grid((unsigned)((slots + SW - 1) / SW),
                  (unsigned)((D + w - 1) / w));
  if (vec)
    bwd_sum<T, true><<<grid, 32 * SW, 0, s>>>(
        static_cast<const T*>(dout), perm, offsets, rows, n_rows,
        static_cast<T*>(dtable), D);
  else
    bwd_sum<T, false><<<grid, 32 * SW, 0, s>>>(
        static_cast<const T*>(dout), perm, offsets, rows, n_rows,
        static_cast<T*>(dtable), D);
  return (int)cudaGetLastError();
}

}  // namespace

// dout: (N, D) of dtype (0 = bfloat16, 1 = float32); idx: (N,) int32 on
// the device; dtable: (R, D) of the same dtype, every row written;
// scratch: 2 R + 2 N + min(N, R) + 2 ints.  Ids outside [0, R) add to no
// row.
// Returns the CUDA error of the launches (0 on success).
extern "C" int burst_gather_bwd(const void* dout, const int* idx,
                                void* dtable, int R, int N, int D, int dtype,
                                int* scratch, void* stream) {
  if (R <= 0 || D <= 0 || N < 0 || D / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(dout, idx, dtable, R, N, D, scratch, s);
  if (dtype == 1)
    return launch_bwd<float>(dout, idx, dtable, R, N, D, scratch, s);
  return (int)cudaErrorInvalidValue;
}
