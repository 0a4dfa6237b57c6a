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
