// SSD (Mamba-2) recurrence, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/mamba2_scan.py, `mamba2_scan` (the Pallas
// `_kernel`, pallas_call at :97), which runs the chunked dual form of the
// scan on the TPU's matrix unit.  Semantics are those of
// repro_torch/kernels/ref.py::mamba2_scan_ref, per (batch b, head h):
//
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T ,   y_t = h_t C_t
//
// with x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B and C (B,S,N) shared by
// all heads, the state (B,H,P,N) f32.  y is written in x's dtype, the
// final state in f32.
//
// What bounds it on an H100: bytes.  At zamba2-7b's prefill (B=4, S=512,
// H=112, P=N=64, bf16) x and y are 29.4 MB each and the state 7.3 MB:
// ~68 MB, ~20 us at 3.35 TB/s.  The recurrence's ~4.7 GFLOP are f32.
// At decode (S=1) reading and writing the state is almost all of it.
//
// What the design does about it, in this first version: one block of 256
// threads per (b, h), looping over time itself (the TPU's sequential chunk
// axis becomes a loop inside the block).  The (P, N) f32 state lives in
// registers: thread t owns row p = t/4 (+64 for P > 64) and the columns
// n = t%4 + 4j, j < V, so y_t[p] is V local FMAs and two shuffles among
// the row's four lanes.  L = 16 steps of x, B, C and dt at a time are
// staged in shared memory as f32, and their y is written back from
// shared memory in one coalesced pass.  The chunked form on tensor cores
// (wgmma) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int G = 4;                // lanes per state row
constexpr int ROWS = NT / G;        // rows one pass of the block covers
constexpr int L = 16;               // time steps staged at once
constexpr int MAXD = 128;           // largest P and N

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
  const void* x; const float* dt; const float* A; const void* B;
  const void* C; const float* h0; void* y; float* hout;
  int S, H, P, N;
  long long xs_b, xs_s, xs_h;       // strides of x (its last is 1)
  long long bs_b, bs_s, cs_b, cs_s; // strides of B and C (their last is 1)
};

// V: state columns per thread (N <= G * V); RI: rows per thread
// (P <= ROWS * RI).
template <typename T, int V, int RI>
__global__ void __launch_bounds__(NT) mamba2_scan_kernel(Args a) {
  __shared__ float sx[L][MAXD];
  __shared__ float sb[L][MAXD];
  __shared__ float sc[L][MAXD];
  __shared__ float sy[L][MAXD];
  __shared__ float sdt[L];

  const int H = a.H, P = a.P, N = a.N, S = a.S;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int g = threadIdx.x % G, r = threadIdx.x / G;
  const float A = a.A[hh];
  const T* x = static_cast<const T*>(a.x) + b * a.xs_b + hh * a.xs_h;
  const T* Bm = static_cast<const T*>(a.B) + b * a.bs_b;
  const T* Cm = static_cast<const T*>(a.C) + b * a.cs_b;
  const float* dt = a.dt + (long long)b * S * H + hh;
  T* y = static_cast<T*>(a.y) + ((long long)b * S * H + hh) * P;
  const long long soff = (long long)bh * P * N;

  float st[RI][V];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int p = r + ROWS * i;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int n = g + G * j;
      st[i][j] = (a.h0 && p < P && n < N) ? a.h0[soff + p * N + n] : 0.f;
    }
  }

  for (int t0 = 0; t0 < S; t0 += L) {
    const int nt = min(L, S - t0);
    for (int e = threadIdx.x; e < nt * P; e += NT) {
      const int tt = e / P, p = e % P;
      sx[tt][p] = to_f(x[(t0 + tt) * a.xs_s + p]);
    }
    for (int e = threadIdx.x; e < nt * N; e += NT) {
      const int tt = e / N, n = e % N;
      sb[tt][n] = to_f(Bm[(t0 + tt) * a.bs_s + n]);
      sc[tt][n] = to_f(Cm[(t0 + tt) * a.cs_s + n]);
    }
    if (threadIdx.x < nt) sdt[threadIdx.x] = dt[(long long)(t0 + threadIdx.x) * H];
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float d = sdt[tt];
      const float decay = expf(d * A);
      float bn[V], cn[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int n = g + G * j;
        bn[j] = n < N ? sb[tt][n] : 0.f;
        cn[j] = n < N ? sc[tt][n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int p = r + ROWS * i;
        const float dx = p < P ? d * sx[tt][p] : 0.f;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          st[i][j] = st[i][j] * decay + dx * bn[j];
          acc += st[i][j] * cn[j];
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (g == 0 && p < P) sy[tt][p] = acc;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nt * P; e += NT) {
      const int tt = e / P, p = e % P;
      y[(long long)(t0 + tt) * H * P + p] = from_f<T>(sy[tt][p]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int p = r + ROWS * i;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int n = g + G * j;
      if (p < P && n < N) a.hout[soff + p * N + n] = st[i][j];
    }
  }
}

template <typename T, int RI>
int launch_v(const Args& a, int grid, cudaStream_t s) {
  if (a.N <= G * 4) mamba2_scan_kernel<T, 4, RI><<<grid, NT, 0, s>>>(a);
  else if (a.N <= G * 8) mamba2_scan_kernel<T, 8, RI><<<grid, NT, 0, s>>>(a);
  else if (a.N <= G * 16) mamba2_scan_kernel<T, 16, RI><<<grid, NT, 0, s>>>(a);
  else mamba2_scan_kernel<T, 32, RI><<<grid, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int grid, cudaStream_t s) {
  return a.P <= ROWS ? launch_v<T, 1>(a, grid, s) : launch_v<T, 2>(a, grid, s);
}

}  // namespace

// x: (B,S,H,P) with strides (xs_b, xs_s, xs_h, 1); dt: (B,S,H) f32; A:
// (H,) f32; B, C: (B,S,N) with strides (*s_b, *s_s, 1); h0: (B,H,P,N) f32
// or null for zeros; y: (B,S,H,P) contiguous; hout: (B,H,P,N) f32.
// dtype: 0 = bf16, 1 = f32 (x, B, C and y).  P and N at most 128.
// Returns the CUDA error of the launch (0 on success).
extern "C" int mamba2_scan_fwd(const void* x, const float* dt, const float* A,
                               const void* B, const void* C, const float* h0,
                               void* y, float* hout, int Bsz, int S, int H,
                               int P, int N, long long xs_b, long long xs_s,
                               long long xs_h, long long bs_b, long long bs_s,
                               long long cs_b, long long cs_s, int dtype,
                               void* stream) {
  if (P < 1 || N < 1 || P > MAXD || N > MAXD || S < 0 || Bsz < 1 || H < 1 ||
      (long long)Bsz * H > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{x, dt, A, B, C, h0, y, hout, S, H, P, N,
               xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<__nv_bfloat16>(a, Bsz * H, s)
                    : launch<float>(a, Bsz * H, s);
}
