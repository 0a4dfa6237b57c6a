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
// 3.35 TB/s.
//
// What the design does about it: one block per tile of IB = 8 indices, as
// in the TPU kernel.  The block loads its indices and checks whether the
// tile is one run (idx[i] == idx[0] + i).  A run is copied as one
// contiguous range of IB rows; any other tile row by row.  Every copy uses
// the widest vector (16 bytes where the row size and pointers allow), with
// neighbouring threads on neighbouring addresses.  An index outside
// [0, R) is never read: its output row is written as zeros (the wrapper
// documents that indices must be in range).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IB = 8;
constexpr int NT = 256;

template <typename V>
__global__ void __launch_bounds__(NT)
burst_gather_kernel(const char* __restrict__ table,
                    const int* __restrict__ idx, char* __restrict__ out,
                    long long R, long long N, long long row_bytes) {
  __shared__ int sidx[IB];
  __shared__ int srun;
  const long long t0 = (long long)blockIdx.x * IB;
  const int n = (int)(N - t0 < IB ? N - t0 : IB);
  if (threadIdx.x < IB) sidx[threadIdx.x] = threadIdx.x < n ? idx[t0 + threadIdx.x] : 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = sidx[0] >= 0 && (long long)sidx[0] + n <= R;
    for (int i = 1; i < n; ++i) run = run && sidx[i] == sidx[0] + i;
    srun = run;
  }
  __syncthreads();

  const long long vpr = row_bytes / (long long)sizeof(V);
  V* dst = reinterpret_cast<V*>(out + t0 * row_bytes);
  if (srun) {
    // the burst: n consecutive table rows are one contiguous range
    const V* src = reinterpret_cast<const V*>(table + (long long)sidx[0] * row_bytes);
    for (long long i = threadIdx.x; i < n * vpr; i += NT) dst[i] = src[i];
    return;
  }
  for (int r = 0; r < n; ++r) {
    const long long row = sidx[r];
    V* d = dst + r * vpr;
    if (row < 0 || row >= R) {
      for (long long i = threadIdx.x; i < vpr; i += NT) d[i] = V{};
      continue;
    }
    const V* s = reinterpret_cast<const V*>(table + row * row_bytes);
    for (long long i = threadIdx.x; i < vpr; i += NT) d[i] = s[i];
  }
}

template <typename V>
int launch(const void* table, const int* idx, void* out, long long R,
           long long N, long long row_bytes, cudaStream_t stream) {
  const long long tiles = (N + IB - 1) / IB;
  burst_gather_kernel<V><<<(unsigned)tiles, NT, 0, stream>>>(
      static_cast<const char*>(table), idx, static_cast<char*>(out), R, N,
      row_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// table: (R, row_bytes) bytes; idx: (N,) int32 on the device; out:
// (N, row_bytes).  Returns the CUDA error of the launch (0 on success).
extern "C" int burst_gather_fwd(const void* table, const int* idx, void* out,
                                long long R, long long N, long long row_bytes,
                                void* stream) {
  if (N == 0 || row_bytes == 0) return 0;
  if ((N + IB - 1) / IB > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(table, idx, out, R, N, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(table, idx, out, R, N, row_bytes, s);
  if (align % 4 == 0) return launch<unsigned>(table, idx, out, R, N, row_bytes, s);
  if (align % 2 == 0)
    return launch<unsigned short>(table, idx, out, R, N, row_bytes, s);
  return launch<unsigned char>(table, idx, out, R, N, row_bytes, s);
}
