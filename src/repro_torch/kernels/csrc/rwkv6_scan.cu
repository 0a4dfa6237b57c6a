// RWKV-6 WKV recurrence with data-dependent decay, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/rwkv6_scan.py, `rwkv6_scan` (the Pallas
// `_kernel`, pallas_call at :106), which runs a chunked form with log-decay
// cumsums on the TPU's matrix unit.  Semantics are those of
// repro_torch/kernels/ref.py::rwkv6_scan_ref, per (batch b, head h), with
// the state S (D_k, D_v) decaying along its key axis i:
//
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
//
// r, k, v and w (B,S,H,D) share one dtype (w is the decay in (0, 1), cast
// to that dtype by the caller); u (H,D) and the state (B,H,D,D) are f32.
// y is written in r's dtype, the final state in f32.
//
// What bounds it on an H100: bytes.  At rwkv6-1.6b's prefill (B=4, S=512,
// H=32, D=64, bf16) r, k, v, w and y are 8.4 MB each and the state 2.1 MB:
// ~44 MB, ~13 us at 3.35 TB/s.  At decode (S=1) the state read and written
// is almost all of the ~4.2 MB.
//
// What the design does about it, in this first version: one block of 256
// threads per (b, h), looping over time itself.  The f32 state lives in
// registers: thread t owns the value column j = t/4 (+64 for D > 64) and
// the key rows i = t%4 + 4q, q < V, so y_t[j] is V local FMAs and two
// shuffles among the column's four lanes.  u stays in registers; L = 16
// steps of r, k, v and w at a time are staged in shared memory as f32, and
// their y is written back from shared memory in one coalesced pass.  With
// only B*H = 128 blocks the card is a quarter full; splitting the value
// axis over more blocks, and the chunked form on tensor cores, are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int G = 4;                // lanes per state column
constexpr int COLS = NT / G;        // columns one pass of the block covers
constexpr int L = 16;               // time steps staged at once
constexpr int MAXD = 128;           // largest head size

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* r; const void* k; const void* v; const void* w;
  const float* u; const float* s0; void* y; float* sout;
  int S, H, D;
};

// V: key rows per thread (D <= G * V); CI: value columns per thread
// (D <= COLS * CI).
template <typename T, int V, int CI>
__global__ void __launch_bounds__(NT) rwkv6_scan_kernel(Args a) {
  __shared__ float sr[L][MAXD];
  __shared__ float sk[L][MAXD];
  __shared__ float sv[L][MAXD];
  __shared__ float sw[L][MAXD];
  __shared__ float sy[L][MAXD];

  const int H = a.H, D = a.D, S = a.S;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int g = threadIdx.x % G, c = threadIdx.x / G;
  // (b, t, hh, :) lies at base + t * H * D
  const long long base = ((long long)b * S * H + hh) * D;
  const long long tstride = (long long)H * D;
  const T* r = static_cast<const T*>(a.r) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* w = static_cast<const T*>(a.w) + base;
  T* y = static_cast<T*>(a.y) + base;
  const long long soff = (long long)bh * D * D;

  float u[V];
  float st[CI][V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int i = g + G * q;
    u[q] = i < D ? a.u[hh * D + i] : 0.f;
  }
#pragma unroll
  for (int ci = 0; ci < CI; ++ci) {
    const int j = c + COLS * ci;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int i = g + G * q;
      st[ci][q] = (a.s0 && i < D && j < D) ? a.s0[soff + i * D + j] : 0.f;
    }
  }

  for (int t0 = 0; t0 < S; t0 += L) {
    const int nt = min(L, S - t0);
    for (int e = threadIdx.x; e < nt * D; e += NT) {
      const int tt = e / D, i = e % D;
      const long long off = (t0 + tt) * tstride + i;
      sr[tt][i] = to_f(r[off]);
      sk[tt][i] = to_f(k[off]);
      sv[tt][i] = to_f(v[off]);
      sw[tt][i] = to_f(w[off]);
    }
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      float rq[V], kq[V], wq[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int i = g + G * q;
        const bool in = i < D;
        rq[q] = in ? sr[tt][i] : 0.f;
        kq[q] = in ? sk[tt][i] : 0.f;
        wq[q] = in ? sw[tt][i] : 0.f;
      }
#pragma unroll
      for (int ci = 0; ci < CI; ++ci) {
        const int j = c + COLS * ci;
        const float vj = j < D ? sv[tt][j] : 0.f;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float kv = kq[q] * vj;
          acc += rq[q] * (st[ci][q] + u[q] * kv);
          st[ci][q] = wq[q] * st[ci][q] + kv;
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (g == 0 && j < D) sy[tt][j] = acc;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nt * D; e += NT) {
      const int tt = e / D, j = e % D;
      y[(t0 + tt) * tstride + j] = from_f<T>(sy[tt][j]);
    }
  }

#pragma unroll
  for (int ci = 0; ci < CI; ++ci) {
    const int j = c + COLS * ci;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int i = g + G * q;
      if (i < D && j < D) a.sout[soff + i * D + j] = st[ci][q];
    }
  }
}

template <typename T, int CI>
int launch_v(const Args& a, int grid, cudaStream_t s) {
  if (a.D <= G * 4) rwkv6_scan_kernel<T, 4, CI><<<grid, NT, 0, s>>>(a);
  else if (a.D <= G * 8) rwkv6_scan_kernel<T, 8, CI><<<grid, NT, 0, s>>>(a);
  else if (a.D <= G * 16) rwkv6_scan_kernel<T, 16, CI><<<grid, NT, 0, s>>>(a);
  else rwkv6_scan_kernel<T, 32, CI><<<grid, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int grid, cudaStream_t s) {
  return a.D <= COLS ? launch_v<T, 1>(a, grid, s) : launch_v<T, 2>(a, grid, s);
}

}  // namespace

// r, k, v, w: (B,S,H,D) contiguous, one dtype; u: (H,D) f32; s0:
// (B,H,D,D) f32 or null for zeros; y: (B,S,H,D) contiguous; sout:
// (B,H,D,D) f32.  dtype: 0 = bf16, 1 = f32.  D at most 128.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const float* u, const float* s0,
                              void* y, float* sout, int Bsz, int S, int H,
                              int D, int dtype, void* stream) {
  if (D < 1 || D > MAXD || S < 0 || Bsz < 1 || H < 1 ||
      (long long)Bsz * H > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, w, u, s0, y, sout, S, H, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<__nv_bfloat16>(a, Bsz * H, s)
                    : launch<float>(a, Bsz * H, s);
}
