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
// What bounds it on an H100: at rwkv6-1.6b's prefill (B=4, S=512, H=32,
// D=64, bf16) r, k, v, w and y are 8.4 MB each and the state 2.1 MB: ~44
// MB, ~13 us at 3.35 TB/s.  The chunked form's ~1.5 GFLOP are f32 FMAs
// (~22 us at 67 TFLOP/s), which hold the f32 y to 2e-4, so at that shape
// the FMA pipes, not the bytes, set the floor; the kernel below runs at
// ~4x it, held back by the shared-memory reads that feed the FMAs and by
// the pair sums, recomputed for each value slice (PERF.md).  At decode
// (S=1) the state read and written is almost all of the ~4.2 MB.
//
// Two forward kernels, and the backward's two at the end of the file; the
// wrapper picks a forward kernel by S (rwkv6_scan.schedule):
//
// - rwkv6_chunked, S >= RT, both dtypes: chunks of RT steps, f32 FMAs.  A
//   block of 128 threads per (b, h, slice of JS value columns): column j
//   of S depends only on v[:, j], so the split is exact; 256 blocks at the
//   serve shape.  The block walks the chunks in order with its (D, JS)
//   slice of the state in registers, each lane a tile of D / 16 rows x 4
//   columns, so that each value read from shared memory feeds 4 to 8
//   FMAs.  Per chunk, with c_t the inclusive cumsum of log(max(w, 1e-30))
//   (the clamp of the Pallas wrapper; w = 0 stays finite and differs from
//   the sequential form only by a state x 1e-30 term):
//     A[t][tau] = sum_i r_t[i] k_tau[i] exp(c_{t-1,i} - c_{tau,i}), tau < t
//     A[t][t]   = sum_i r_t[i] u[i] k_t[i]                 (the bonus)
//     y_t       = (r_t o exp(c_{t-1})) @ S + sum_{tau <= t} A[t][tau] v_tau
//     S        <- exp(c_T) o S + (k o exp(c_T - c))^T @ v
//   Every exponent is <= 0, and none is taken of -c alone (the Pallas
//   kernel's exp(-c) overflows once c < -88.7).  Each exp(c_a - c_b) is the
//   product of the clamped decays between b and a: running products on the
//   FMA pipes, not the special-function unit, which has an eighth of their
//   rate.  A is formed per lane as the bonus terms of two steps and 15
//   steps of the product chains of tau and RT - 1 - tau, over 16 channel
//   groups summed in shared memory.  A lane's share of y (its rows of the
//   inter-chunk sum, and the intra-chunk term of one step tau) is summed
//   over the warp's lanes by shuffles and over the 4 warps in shared
//   memory.  The next chunk's r, k, v and w come into registers while the
//   current one computes.  Slices of 16 and 64 columns, and lanes of 8
//   rows x 1 column, measured slower (PERF.md).
// - rwkv6_seq, S < RT (the model's decode step): the sequential form in
//   f32, the port's first layout kept: a block of 256 threads per (b, h),
//   lane t owns value column t / 4 and key rows t % 4 + 4 q, so a warp
//   load of the state covers 4 rows x 8 columns, whole 32-byte sectors,
//   all of a lane's loads before its arithmetic, and y[j] is two
//   shuffles.  16-byte runs of columns over 512 blocks measured slower at
//   decode: the 2.1 MB state is read in one wave either way, and their sum
//   over 32 lanes of rows costs more than the wider loads save (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "scan_bwd.cuh"

namespace {

constexpr int MAXD = 128;           // largest head size

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* r; const void* k; const void* v; const void* w;
  const float* u; const float* s0; void* y; float* sout;
  int S, H, D;
};

// ------------------------------------------------- sequential: rwkv6_seq
constexpr int SQ_NT = 256;          // threads per block
constexpr int SQ_G = 4;             // lanes per state column
constexpr int SQ_COLS = SQ_NT / SQ_G;  // columns one pass of the block covers
constexpr int SQ_L = 16;            // time steps staged at once

// V: key rows per lane (D <= SQ_G V); CI: value columns per lane
// (D <= SQ_COLS CI).  Lane t owns column t / 4 (+64) and rows t % 4 + 4 q:
// a warp load covers 4 rows x 8 consecutive columns, whole 32-byte sectors.
template <typename T, int V, int CI>
__global__ void __launch_bounds__(SQ_NT) rwkv6_seq(Args a) {
  __shared__ float sr[SQ_L][MAXD];
  __shared__ float sk[SQ_L][MAXD];
  __shared__ float sv[SQ_L][MAXD];
  __shared__ float sw[SQ_L][MAXD];
  __shared__ float sy[SQ_L][MAXD];

  const int H = a.H, D = a.D, S = a.S;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int g = threadIdx.x % SQ_G, c = threadIdx.x / SQ_G;
  const long long soff = (long long)bh * D * D;

  // the state first: every load of this lane in flight before any use
  float st[CI][V];
#pragma unroll
  for (int ci = 0; ci < CI; ++ci) {
    const int j = c + SQ_COLS * ci;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int i = g + SQ_G * q;
      st[ci][q] = (a.s0 && i < D && j < D) ? a.s0[soff + i * D + j] : 0.f;
    }
  }
  float u[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int i = g + SQ_G * q;
    u[q] = i < D ? a.u[hh * D + i] : 0.f;
  }

  // (b, t, hh, :) lies at base + t * H * D
  const long long base = ((long long)b * S * H + hh) * D;
  const long long tstride = (long long)H * D;
  const T* r = static_cast<const T*>(a.r) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* w = static_cast<const T*>(a.w) + base;
  T* y = static_cast<T*>(a.y) + base;

  for (int t0 = 0; t0 < S; t0 += SQ_L) {
    const int nt = min(SQ_L, S - t0);
    for (int e = threadIdx.x; e < nt * D; e += SQ_NT) {
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
        const int i = g + SQ_G * q;
        const bool in = i < D;
        rq[q] = in ? sr[tt][i] : 0.f;
        kq[q] = in ? sk[tt][i] : 0.f;
        wq[q] = in ? sw[tt][i] : 0.f;
      }
#pragma unroll
      for (int ci = 0; ci < CI; ++ci) {
        const int j = c + SQ_COLS * ci;
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
    for (int e = threadIdx.x; e < nt * D; e += SQ_NT) {
      const int tt = e / D, j = e % D;
      y[(t0 + tt) * tstride + j] = from_f<T>(sy[tt][j]);
    }
  }

#pragma unroll
  for (int ci = 0; ci < CI; ++ci) {
    const int j = c + SQ_COLS * ci;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int i = g + SQ_G * q;
      if (i < D && j < D) a.sout[soff + i * D + j] = st[ci][q];
    }
  }
}

template <typename T, int CI>
void launch_seq_ci(const Args& a, int grid, cudaStream_t s) {
  if (a.D <= SQ_G * 4) rwkv6_seq<T, 4, CI><<<grid, SQ_NT, 0, s>>>(a);
  else if (a.D <= SQ_G * 8) rwkv6_seq<T, 8, CI><<<grid, SQ_NT, 0, s>>>(a);
  else if (a.D <= SQ_G * 16) rwkv6_seq<T, 16, CI><<<grid, SQ_NT, 0, s>>>(a);
  else rwkv6_seq<T, 32, CI><<<grid, SQ_NT, 0, s>>>(a);
}

template <typename T>
int launch_seq(const Args& a, int grid, cudaStream_t s) {
  if (a.D <= SQ_COLS) launch_seq_ci<T, 1>(a, grid, s);
  else launch_seq_ci<T, 2>(a, grid, s);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- chunked: rwkv6_chunked
constexpr int RT = 16;              // steps per chunk
constexpr int JS = 32;              // value columns per block
constexpr int NT = 128;             // threads per block
constexpr int NG = NT / 8;          // channel groups of the pair chains
constexpr int PP = RT * RT + 8;     // pitch of a group's partial sums

template <int DB>
struct WkvSmem {
  static constexpr int RP = DB + 4; // row pitch: conflict-free 16-byte reads
  float r[RT][RP], k[RT][RP];
  float w[RT][RP];                  // max(w, 1e-30); 1 past S and D
  float rt[RT][RP];                 // r_t exp(c_{t-1})
  float kt[RT][RP];                 // k_t exp(c_T - c_t)
  float v[RT][JS];
  float u[DB], eT[DB];              // eT = exp(c_T)
  float part[NG][PP];               // per channel group: A[t][tau] at
                                    // t RT + tau
  float AT[RT][RT + 4];             // A transposed
  float red[NT / 32][RT][JS];       // y's partial sums, by warp
};

template <int M>
__device__ __forceinline__ void lds(float* d, const float* p) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int m = 0; m < M; m += 4)
      *reinterpret_cast<float4*>(d + m) =
          *reinterpret_cast<const float4*>(p + m);
  } else {
#pragma unroll
    for (int m = 0; m < M; m += 2)
      *reinterpret_cast<float2*>(d + m) =
          *reinterpret_cast<const float2*>(p + m);
  }
}

// DB: D padded to 32, 64 or 128; vec: r, k, v, w take 16-byte loads.
// Lane (rg, cg) = (tid / 8, tid % 8) holds the state's rows
// RQ rg .. RQ rg + RQ - 1 of columns j0 + 4 cg .. + 3: each shared-memory
// read feeds 4 RQ FMAs.
template <typename T, int DB>
__global__ void __launch_bounds__(NT) rwkv6_chunked(Args a, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WkvSmem<DB>& sm = *reinterpret_cast<WkvSmem<DB>*>(smem_raw);
  constexpr int RQ = DB / 16;       // state rows per lane
  constexpr int MI = DB / NG;       // channels per lane in the pair chains
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte unit
  constexpr int UR = DB / VE;       // units per row of r, k, w
  constexpr int NU = (RT * UR + NT - 1) / NT;  // units per lane and matrix
  constexpr int UV = JS / VE;       // units per row of the v slice

  const int H = a.H, D = a.D, S = a.S;
  const int nsl = (D + JS - 1) / JS;
  const int bh = blockIdx.x / nsl, j0 = (blockIdx.x % nsl) * JS;
  const int b = bh / H, hh = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid >> 3, cg = tid & 7;
  const int i0 = RQ * rg, jc = 4 * cg;  // this lane's rows and columns
  const long long base = ((long long)b * S * H + hh) * D;
  const long long ts = (long long)H * D;
  const T* r = static_cast<const T*>(a.r) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* w = static_cast<const T*>(a.w) + base;
  T* y = static_cast<T*>(a.y) + base;
  const int nc = (S + RT - 1) / RT;

  for (int i = tid; i < DB; i += NT) sm.u[i] = i < D ? a.u[hh * D + i] : 0.f;

  float st[RQ][4];
#pragma unroll
  for (int e = 0; e < RQ; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + e, j = j0 + jc + q;
      st[e][q] = a.s0 && i < D && j < D
                     ? a.s0[((long long)bh * D + i) * D + j] : 0.f;
    }

  // r, k, w (all D columns) and v (this block's JS) of chunk ci into
  // registers, zeros past S and D
  uint4 rq[NU], kq[NU], wq[NU], vq;
  auto load_chunk = [&](int ci) {
    const int t0 = ci * RT;
#pragma unroll
    for (int n = 0; n < NU; ++n) {
      const int q = tid + NT * n, t = q / UR, col = VE * (q % UR);
      rq[n] = kq[n] = wq[n] = make_uint4(0, 0, 0, 0);
      if (q >= RT * UR || t0 + t >= S || col >= D) continue;
      const long long off = (t0 + t) * ts + col;
      if (vec) {
        rq[n] = *reinterpret_cast<const uint4*>(r + off);
        kq[n] = *reinterpret_cast<const uint4*>(k + off);
        wq[n] = *reinterpret_cast<const uint4*>(w + off);
      } else {
        T* rv = reinterpret_cast<T*>(&rq[n]);
        T* kv = reinterpret_cast<T*>(&kq[n]);
        T* wv = reinterpret_cast<T*>(&wq[n]);
#pragma unroll
        for (int e = 0; e < VE; ++e)
          if (col + e < D) {
            rv[e] = r[off + e];
            kv[e] = k[off + e];
            wv[e] = w[off + e];
          }
      }
    }
    vq = make_uint4(0, 0, 0, 0);
    const int t = tid / UV, col = j0 + VE * (tid % UV);
    if (tid < RT * UV && t0 + t < S && col < D) {
      const long long off = (t0 + t) * ts + col;
      if (vec) {
        vq = *reinterpret_cast<const uint4*>(v + off);
      } else {
        T* vv = reinterpret_cast<T*>(&vq);
#pragma unroll
        for (int e = 0; e < VE; ++e)
          if (col + e < D) vv[e] = v[off + e];
      }
    }
  };
  // the registers of chunk ci into shared memory as f32, w clamped
  auto store_chunk = [&](int ci) {
#pragma unroll
    for (int n = 0; n < NU; ++n) {
      const int q = tid + NT * n, t = q / UR, col = VE * (q % UR);
      if (q >= RT * UR) continue;
      const bool live = ci * RT + t < S;
      const T* rv = reinterpret_cast<const T*>(&rq[n]);
      const T* kv = reinterpret_cast<const T*>(&kq[n]);
      const T* wv = reinterpret_cast<const T*>(&wq[n]);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        sm.r[t][col + e] = to_f(rv[e]);
        sm.k[t][col + e] = to_f(kv[e]);
        sm.w[t][col + e] = live && col + e < D
                               ? fmaxf(to_f(wv[e]), 1e-30f) : 1.f;
      }
    }
    if (tid < RT * UV) {
      const int t = tid / UV, col = VE * (tid % UV);
      const T* vv = reinterpret_cast<const T*>(&vq);
#pragma unroll
      for (int e = 0; e < VE; ++e) sm.v[t][col + e] = to_f(vv[e]);
    }
  };

  load_chunk(0);
  for (int ci = 0; ci < nc; ++ci) {
    __syncthreads();                // the last chunk's readers are done
    store_chunk(ci);
    if (ci + 1 < nc) load_chunk(ci + 1);
    __syncthreads();

    // decay products: exp(c_{t-1}) into rt, exp(c_T - c_t) into kt, exp(c_T)
    for (int e = tid; e < 2 * DB; e += NT) {
      const int i = e % DB;
      float E = 1.f;
      if (e < DB) {
#pragma unroll
        for (int t = 0; t < RT; ++t) {
          sm.rt[t][i] = sm.r[t][i] * E;
          E *= sm.w[t][i];
        }
        sm.eT[i] = E;
      } else {
#pragma unroll
        for (int t = RT - 1; t >= 0; --t) {
          sm.kt[t][i] = sm.k[t][i] * E;
          E *= sm.w[t][i];
        }
      }
    }
    // pair sums over channels ci0 .. ci0 + MI: the bonus terms of t = tp
    // and RT - 1 - tp, then the chain of tau = tp and that of
    // tau = RT - 1 - tp, each from t = tau + 1 up
    {
      const int tp = tid & 7, ig = tid >> 3, ci0 = ig * MI;
      float q[MI], uu[MI], rr[MI], ww[MI];
      lds<MI>(uu, &sm.u[ci0]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = hf ? RT - 1 - tp : tp;
        lds<MI>(rr, &sm.r[t][ci0]);
        lds<MI>(q, &sm.k[t][ci0]);
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < MI; ++m) acc += rr[m] * (uu[m] * q[m]);
        sm.part[ig][t * RT + t] = acc;
      }
      int tau = tp, t = tp + 1;
      lds<MI>(q, &sm.k[tau][ci0]);
#pragma unroll
      for (int n = 0; n < RT - 1; ++n) {
        if (n == RT - 1 - tp) {
          tau = RT - 1 - tp;
          t = tau + 1;
          lds<MI>(q, &sm.k[tau][ci0]);
        }
        lds<MI>(rr, &sm.r[t][ci0]);
        lds<MI>(ww, &sm.w[t][ci0]);
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < MI; ++m) {
          acc += rr[m] * q[m];
          q[m] *= ww[m];
        }
        sm.part[ig][t * RT + tau] = acc;
        ++t;
      }
    }
    __syncthreads();

    // A, transposed (AT[tau][t]), zero above the diagonal
    for (int e = tid; e < RT * RT; e += NT) {
      const int t = e / RT, tau = e % RT;
      float s = 0.f;
      if (tau <= t) {
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) s += sm.part[gi][e];
      }
      sm.AT[tau][t] = s;
    }
    __syncthreads();

    // this lane's share of y (16 steps x its 4 columns): the inter-chunk
    // sum over its rows, with the state entering the chunk, and the
    // intra-chunk term of tau = rg
    float acc[RT][4];
    {
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[rg][jc]);
#pragma unroll
      for (int t4 = 0; t4 < RT; t4 += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&sm.AT[rg][t4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          acc[t4 + tt][0] = av[tt] * vv.x;
          acc[t4 + tt][1] = av[tt] * vv.y;
          acc[t4 + tt][2] = av[tt] * vv.z;
          acc[t4 + tt][3] = av[tt] * vv.w;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      float rv[RQ];
      lds<RQ>(rv, &sm.rt[t][i0]);
#pragma unroll
      for (int e = 0; e < RQ; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][q] += rv[e] * st[e][q];
    }
    // the state update
    {
      float eT[RQ];
      lds<RQ>(eT, &sm.eT[i0]);
#pragma unroll
      for (int e = 0; e < RQ; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) st[e][q] *= eT[e];
    }
#pragma unroll
    for (int tau = 0; tau < RT; ++tau) {
      float kv[RQ];
      lds<RQ>(kv, &sm.kt[tau][i0]);
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[tau][jc]);
#pragma unroll
      for (int e = 0; e < RQ; ++e) {
        st[e][0] += kv[e] * vv.x;
        st[e][1] += kv[e] * vv.y;
        st[e][2] += kv[e] * vv.z;
        st[e][3] += kv[e] * vv.w;
      }
    }
    // sum acc over the warp's 4 row groups (lane bits 3 and 4), leaving
    // lane bit b4 with steps 8 b4 + 4 b3 .. + 3, then over the warps
    float a8[8][4], a4[4][4];
    {
      const bool hi = lane & 16;
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a8[m][q] = (hi ? acc[8 + m][q] : acc[m][q]) +
                     __shfl_xor_sync(0xffffffffu,
                                     hi ? acc[m][q] : acc[8 + m][q], 16);
    }
    {
      const bool hi = lane & 8;
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a4[m][q] = (hi ? a8[4 + m][q] : a8[m][q]) +
                     __shfl_xor_sync(0xffffffffu,
                                     hi ? a8[m][q] : a8[4 + m][q], 8);
    }
    const int tb = 8 * ((lane >> 4) & 1) + 4 * ((lane >> 3) & 1);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      *reinterpret_cast<float4*>(&sm.red[warp][tb + m][jc]) =
          make_float4(a4[m][0], a4[m][1], a4[m][2], a4[m][3]);
    __syncthreads();
#pragma unroll
    for (int e = tid; e < RT * JS; e += NT) {
      const int t = e / JS, j = e % JS, tg = ci * RT + t;
      float yv = 0.f;
#pragma unroll
      for (int q = 0; q < NT / 32; ++q) yv += sm.red[q][t][j];
      if (tg < S && j0 + j < D) y[tg * ts + j0 + j] = from_f<T>(yv);
    }
  }

#pragma unroll
  for (int e = 0; e < RQ; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + e, j = j0 + jc + q;
      if (i < D && j < D) a.sout[((long long)bh * D + i) * D + j] = st[e][q];
    }
}

template <typename T, int DB>
int launch_chunked_db(const Args& a, int grid, int vec, cudaStream_t s) {
  const int smem = (int)sizeof(WkvSmem<DB>);
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunked<T, DB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunked<T, DB><<<grid, NT, smem, s>>>(a, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunked(const Args& a, int grid, int vec, cudaStream_t s) {
  if (a.D <= 32) return launch_chunked_db<T, 32>(a, grid, vec, s);
  if (a.D <= 64) return launch_chunked_db<T, 64>(a, grid, vec, s);
  return launch_chunked_db<T, 128>(a, grid, vec, s);
}

// -------------------------------- backward: rwkv6_bwd_scan, rwkv6_bwd_sum
// Replaces no TPU kernel: the reference trains through its jnp ref
// (src/repro/kernels/ref.py::rwkv6_scan_ref) and has no custom_vjp, so
// this is the gradient of the Pallas kernel above.  What bounds it on an
// H100: bytes.  At rwkv6-1.6b's training shape (B=4, S=1024, H=32, D=64,
// bf16) r, k, v, w, dy and their four gradients are 16.8 MB each, ~153 MB
// in all, ~0.046 ms at 3.35 TB/s; its f32 FMAs need ~0.12 ms.
//
// Why no chunked form: dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j] needs the
// state before, and the gradient after, every step; a chunked form yields
// d(log w), and dw from it divides by w, which is 0 or 1e-30 in places.
// The per-step walk below takes no exponential and no logarithm and
// divides by nothing, in both dtypes (so the f32 checks test this kernel).
//
// The layout and schedule of scan_bwd.cuh (RB_*): a block of RB_NT = 256
// threads per (b, h, slice of 32 key rows i), 8 lanes a row, 4 or 8
// columns of the row a lane, two blocks an SM at D <= 64 (256 blocks at
// the training shape, one wave).  Per row, with G_t the gradient of the
// state after step t (the final state's gradient at t = S) and S_{t-1}
// the state before it:
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u_i k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i,j] v_t[j]     + u_i r_t[i] (v_t . dy_t)
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   dv_t[j] += k_t[i] (G_t[i,j] + u_i r_t[i] dy_t[j])
//   du[i]  += r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1}[i,:] = r_t[i] dy_t + w_t[i] G_t[i,:] ,  dS_0 = G_0
// A forward walk writes the state before every piece of RB_K = 8 steps
// (device memory: 268 MB at the training shape); the reverse walk, piece
// by piece from the last, steps forward from the piece's checkpoint (its
// load issued a piece ahead) keeping the 8 states in registers, then walks
// them back: each step twice forward, once backward (the sequential
// kernel before it: three times and once).  k, w, r, v and dy come 64
// steps at a time by cp.async (16-byte copies, zeros past S and D; element
// by element where D or an address does not allow them) into a landing
// buffer in their dtype, which is converted once a chunk into f32 arrays
// the walk reads (with v_t . dy_t for each step, the same for every row),
// so the next chunk's loads are in flight during this one's walk.  dr, dk
// and dw and each warp's dv (its four rows summed by shuffles) wait in
// shared memory for the piece's end, where the block sums dv over the
// warps in order and writes all four; two barriers a piece and two a
// chunk, none a step.
// rwkv6_bwd_scan writes dr, dk, dw, dS_0 and each block's partial dv (a
// step each) and du; rwkv6_bwd_sum adds the partials in block order and
// rounds dv once to its dtype.

struct BwdArgs {
  const void* r; const void* k; const void* v; const void* w;
  const float* u; const float* s0; const void* dy; const float* dsT;
  void* dr; void* dk; void* dw; float* ds0;
  float4* ckpt; float* dv_part; float* du_part;
  int S, H, D, nsl, npc;              // npc: pieces of RB_K steps
};

// NV: float4 of a row a lane (columns 32 NV).  The loads land in the
// inputs' dtype (the l* arrays) while the block walks the chunk before,
// which it reads in f32 from the others, converted once a chunk.
template <typename T, int NV>
struct R6BwdSmem {
  static constexpr int DP = 32 * NV;
  T lk[RB_CH][RB_ROWS], lw[RB_CH][RB_ROWS], lr[RB_CH][RB_ROWS];
  T lv[RB_CH][DP], ldy[RB_CH][DP];
  float k[RB_CH][RB_ROWS], w[RB_CH][RB_ROWS], r[RB_CH][RB_ROWS];
  float v[RB_CH][DP], dy[RB_CH][DP];
  float vdy[RB_CH];                        // v_t . dy_t
  float red[RB_K][RB_WARPS][DP];           // a warp's dv, a piece's steps
  float out[3][RB_K][RB_ROWS];             // a piece's dr, dk, dw
};

// four consecutive f32 of shared memory
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Load steps [t0, t0 + RB_CH) of the block's rows of k and w and of v
// (and, in reverse, r and dy) into the landing arrays, zeros past S and D,
// as one cp.async group of this thread.  VEC: 16-byte copies (D a
// multiple of 16 bytes, every tensor 16-byte aligned); else element by
// element, done when this returns.
template <typename T, int NV, bool VEC>
__device__ __forceinline__ void r6_stage(const BwdArgs& a,
                                         R6BwdSmem<T, NV>& sm,
                                         long long base, int i0, int t0,
                                         bool rev) {
  constexpr int DP = 32 * NV, EC = VEC ? 16 / (int)sizeof(T) : 1;
  constexpr int NR = RB_ROWS / EC, NC = DP / EC;
  const long long tstride = (long long)a.H * a.D;
  const T *k = static_cast<const T*>(a.k), *w = static_cast<const T*>(a.w);
  const T *r = static_cast<const T*>(a.r), *v = static_cast<const T*>(a.v);
  const T* dy = static_cast<const T*>(a.dy);
  for (int e = threadIdx.x; e < RB_CH * NR; e += RB_NT) {
    const int tt = e / NR, m = e % NR * EC, t = t0 + tt;
    const bool ok = t < a.S && i0 + m < a.D;
    const long long off = ok ? base + t * tstride + i0 + m : 0;
    if constexpr (VEC) {
      cp_async16(&sm.lk[tt][m], k + off, ok ? 16 : 0);
      cp_async16(&sm.lw[tt][m], w + off, ok ? 16 : 0);
      if (rev) cp_async16(&sm.lr[tt][m], r + off, ok ? 16 : 0);
    } else {
      sm.lk[tt][m] = ok ? k[off] : from_f<T>(0.f);
      sm.lw[tt][m] = ok ? w[off] : from_f<T>(0.f);
      if (rev) sm.lr[tt][m] = ok ? r[off] : from_f<T>(0.f);
    }
  }
  for (int e = threadIdx.x; e < RB_CH * NC; e += RB_NT) {
    const int tt = e / NC, j = e % NC * EC, t = t0 + tt;
    const bool ok = t < a.S && j < a.D;
    const long long off = ok ? base + t * tstride + j : 0;
    if constexpr (VEC) {
      cp_async16(&sm.lv[tt][j], v + off, ok ? 16 : 0);
      if (rev) cp_async16(&sm.ldy[tt][j], dy + off, ok ? 16 : 0);
    } else {
      sm.lv[tt][j] = ok ? v[off] : from_f<T>(0.f);
      if (rev) sm.ldy[tt][j] = ok ? dy[off] : from_f<T>(0.f);
    }
  }
  cp_async_commit();
}

// The landed chunk into the f32 arrays (all threads; the caller waits for
// its loads and syncs before, and syncs after); in reverse also v_t . dy_t
// for each step t, by warp w for steps 8 w to 8 w + 7: lane l's products
// j = l + 32 m (m < NV) in order, then the warp's butterfly
template <typename T, int NV>
__device__ __forceinline__ void r6_convert(R6BwdSmem<T, NV>& sm, bool rev) {
  constexpr int DP = 32 * NV;
  for (int e = threadIdx.x; e < RB_CH * RB_ROWS; e += RB_NT) {
    const int t = e / RB_ROWS, i = e % RB_ROWS;
    sm.k[t][i] = to_f(sm.lk[t][i]);
    sm.w[t][i] = to_f(sm.lw[t][i]);
    if (rev) sm.r[t][i] = to_f(sm.lr[t][i]);
  }
  for (int e = threadIdx.x; e < RB_CH * DP; e += RB_NT) {
    const int t = e / DP, j = e % DP;
    sm.v[t][j] = to_f(sm.lv[t][j]);
    if (rev) sm.dy[t][j] = to_f(sm.ldy[t][j]);
  }
  if (!rev) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int t = RB_CH / RB_WARPS * warp; t < RB_CH / RB_WARPS * (warp + 1);
       ++t) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < NV; ++m)
      acc += to_f(sm.lv[t][lane + 32 * m]) * to_f(sm.ldy[t][lane + 32 * m]);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) sm.vdy[t] = acc;
  }
}

// S[i,:] <- w_t[i] S[i,:] + k_t[i] v_t at step t of the f32 chunk
template <typename T, int NV>
__device__ __forceinline__ void r6_step(float (&st)[4 * NV],
                                        const R6BwdSmem<T, NV>& sm, int t,
                                        int g, int r) {
  const float ki = sm.k[t][r], wi = sm.w[t][r];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float4 vq = ld4(&sm.v[t][4 * (g + RB_G * j)]);
    st[4 * j] = wi * st[4 * j] + ki * vq.x;
    st[4 * j + 1] = wi * st[4 * j + 1] + ki * vq.y;
    st[4 * j + 2] = wi * st[4 * j + 2] + ki * vq.z;
    st[4 * j + 3] = wi * st[4 * j + 3] + ki * vq.w;
  }
}

template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(RB_NT, NV <= 2 ? 2 : 1)
rwkv6_bwd_scan(BwdArgs a) {
  constexpr int E = 4 * NV, DP = 32 * NV, PIECES = RB_CH / RB_K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<R6BwdSmem<T, NV>*>(smem_raw);
  const int tid = threadIdx.x, g = tid % RB_G, r = tid / RB_G;
  const int warp = tid / 32, lane = tid % 32;
  const int H = a.H, D = a.D, S = a.S;
  const int bh = blockIdx.x / a.nsl, sl = blockIdx.x % a.nsl;
  const int b = bh / H, hh = bh % H, i0 = sl * RB_ROWS, i = i0 + r;
  const bool row = i < D;
  const float ui = row ? a.u[hh * D + i] : 0.f;
  // (b, t, hh, :) lies at base + t H D
  const long long base = ((long long)b * S * H + hh) * D;
  const long long tstride = (long long)H * D;
  float4* ck = a.ckpt + (long long)blockIdx.x * a.npc * NV * RB_NT + tid;
  const long long srow = ((long long)bh * D + i) * D;
  const int nck = (S + RB_CH - 1) / RB_CH;

  // forward: the state before each piece of RB_K steps
  float st[E];
  bw_load_row<E, RB_G>(st, a.s0 ? a.s0 + srow : nullptr, g, D, row);
  if (nck) r6_stage<T, NV, VEC>(a, sm, base, i0, 0, false);
  for (int c = 0; c < nck; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    r6_convert<T, NV>(sm, false);
    __syncthreads();
    if (c + 1 < nck)
      r6_stage<T, NV, VEC>(a, sm, base, i0, (c + 1) * RB_CH, false);
    const int np = (min(RB_CH, S - c * RB_CH) + RB_K - 1) / RB_K;
    for (int s = 0; s < np; ++s) {
      bw_put<E, RB_NT>(ck + (long long)(c * PIECES + s) * NV * RB_NT, st);
      if (c == nck - 1 && s == np - 1) break;
#pragma unroll
      for (int k = 0; k < RB_K; ++k)
        r6_step<T, NV>(st, sm, s * RB_K + k, g, r);
    }
  }
  __syncthreads();

  // reverse, piece by piece from the last
  float carry[E];                   // G_t
  bw_load_row<E, RB_G>(carry, a.dsT ? a.dsT + srow : nullptr, g, D, row);
  float du_acc = 0.f;
  float next[E];                    // the checkpoint of the piece to walk
  if (a.npc) bw_get<E, RB_NT>(next, ck + (long long)(a.npc - 1) * NV * RB_NT);
  if (nck) r6_stage<T, NV, VEC>(a, sm, base, i0, (nck - 1) * RB_CH, true);
  for (int c = nck - 1; c >= 0; --c) {
    cp_async_wait<0>();
    __syncthreads();
    r6_convert<T, NV>(sm, true);
    __syncthreads();
    if (c > 0) r6_stage<T, NV, VEC>(a, sm, base, i0, (c - 1) * RB_CH, true);
    const int t0 = c * RB_CH;
    const int np = (min(RB_CH, S - t0) + RB_K - 1) / RB_K;
    for (int s = np - 1; s >= 0; --s) {
      const int pc = c * PIECES + s, ts = t0 + s * RB_K;
      const int n = min(RB_K, S - ts);
      float h0s[E];
#pragma unroll
      for (int e = 0; e < E; ++e) st[e] = h0s[e] = next[e];
      if (pc > 0)
        bw_get<E, RB_NT>(next, ck + (long long)(pc - 1) * NV * RB_NT);
      float hist[RB_K][E];
#pragma unroll
      for (int k = 0; k < RB_K; ++k) {
        if (k < n) r6_step<T, NV>(st, sm, s * RB_K + k, g, r);
#pragma unroll
        for (int e = 0; e < E; ++e) hist[k][e] = st[e];
      }
#pragma unroll
      for (int k = RB_K - 1; k >= 0; --k) {
        if (k >= n) continue;
        const int tl = s * RB_K + k;
        const float ri = sm.r[tl][r], ki = sm.k[tl][r], wi = sm.w[tl][r];
        const float sdv = sm.vdy[tl];
        float sgv = 0.f, sdh = 0.f, sgh = 0.f, pv[E];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float4 vq = ld4(&sm.v[tl][4 * (g + RB_G * j)]);
          const float4 dq = ld4(&sm.dy[tl][4 * (g + RB_G * j)]);
          const float vv[4] = {vq.x, vq.y, vq.z, vq.w};
          const float dd[4] = {dq.x, dq.y, dq.z, dq.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = 4 * j + q;
            const float G = carry[e];
            const float hprev = k ? hist[k - 1][e] : h0s[e];
            sgv += G * vv[q];
            sdh += dd[q] * hprev;
            sgh += G * hprev;
            pv[e] = ki * (G + ui * ri * dd[q]);
            carry[e] = ri * dd[q] + wi * G;
          }
        }
        // the row's three sums: lanes g = 0, 2, 4 hold sgv, sdh, sgh
        const float rs = rb_row_sums3(sgv, sdh, sgh, g);
        if (g == 0) sm.out[1][k][r] = rs + ui * ri * sdv;
        if (g == 2) sm.out[0][k][r] = rs + ui * ki * sdv;
        if (g == 4) sm.out[2][k][r] = rs;
        du_acc += ri * ki * sdv;
        // dv over the warp's four rows: this lane's E / 4 columns
        float pw[E / 4];
        rb_warp_rows_sums<E>(pv, pw, lane >> 3);
        const int i0w = (lane >> 3 & 1) * (E / 2) + (lane >> 4 & 1) * (E / 4);
#pragma unroll
        for (int m = 0; m < E / 4; ++m)
          sm.red[k][warp][bw_col<RB_G>(g, i0w + m)] = pw[m];
      }
      __syncthreads();
      // the piece's dv partial (the warps in order) and dr, dk, dw
      for (int e = tid; e < n * DP; e += RB_NT) {
        const int k = e / DP, j = e % DP;
        if (j >= D) continue;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < RB_WARPS; ++w) acc += sm.red[k][w][j];
        a.dv_part[((((long long)b * S + ts + k) * H + hh) * a.nsl + sl) * D +
                  j] = acc;
      }
      for (int e = tid; e < 3 * n * RB_ROWS; e += RB_NT) {
        const int o = e / (n * RB_ROWS), k = e / RB_ROWS % n;
        const int rr = e % RB_ROWS;
        if (i0 + rr >= D) continue;
        T* dst = static_cast<T*>(o == 0 ? a.dr : o == 1 ? a.dk : a.dw);
        dst[base + (ts + k) * tstride + i0 + rr] =
            from_f<T>(sm.out[o][k][rr]);
      }
      __syncthreads();
    }
  }

  bw_store_row<E, RB_G>(carry, a.ds0 + srow, g, D, row);
  if (g == 0 && row) a.du_part[((long long)b * H + hh) * D + i] = du_acc;
}

// dv (B,S,H,D) in T and du (H,D) f32: the partials in block order
template <typename T>
__global__ void rwkv6_bwd_sum(BwdArgs a, int Bsz, void* dv, float* du) {
  const long long nv = (long long)Bsz * a.S * a.H * a.D;
  const long long total = nv + (long long)a.H * a.D;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (e < nv) {
      const long long bth = e / a.D;
      const int j = (int)(e % a.D);
      for (int s = 0; s < a.nsl; ++s)
        acc += a.dv_part[(bth * a.nsl + s) * a.D + j];
      static_cast<T*>(dv)[e] = from_f<T>(acc);
    } else {
      const long long f = e - nv;   // hh D + i
      for (int b = 0; b < Bsz; ++b)
        acc += a.du_part[(long long)b * a.H * a.D + f];
      du[f] = acc;
    }
  }
}

template <typename T, int NV, bool VEC>
int launch_bwd_nv(const BwdArgs& a, int grid, cudaStream_t s) {
  const int smem = (int)sizeof(R6BwdSmem<T, NV>);
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_scan<T, NV, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_scan<T, NV, VEC><<<grid, RB_NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const BwdArgs& a, int Bsz, int grid, int vec, void* dv,
               float* du, cudaStream_t s) {
  const int err =
      a.D <= 64 ? (vec ? launch_bwd_nv<T, 2, true>(a, grid, s)
                       : launch_bwd_nv<T, 2, false>(a, grid, s))
                : (vec ? launch_bwd_nv<T, 4, true>(a, grid, s)
                       : launch_bwd_nv<T, 4, false>(a, grid, s));
  if (err) return err;
  const long long total = (long long)Bsz * a.S * a.H * a.D +
                          (long long)a.H * a.D;
  const int blocks = (int)(total < 4096 * 256 ? (total + 255) / 256 : 4096);
  rwkv6_bwd_sum<T><<<blocks, 256, 0, s>>>(a, Bsz, dv, du);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// launches of rwkv6_bwd_scan by how it stages its inputs: [1] by 16-byte
// cp.async, [0] element by element
long long g_bwd_launches[2] = {0, 0};

}  // namespace

// r, k, v, w: (B,S,H,D) contiguous, one dtype; u: (H,D) f32; s0:
// (B,H,D,D) f32 or null for zeros; y: (B,S,H,D) contiguous; sout:
// (B,H,D,D) f32.  dtype: 0 = bf16, 1 = f32.  chunked: 1 for the chunked
// kernel, 0 for the sequential one.  D at most 128.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const float* u, const float* s0,
                              void* y, float* sout, int Bsz, int S, int H,
                              int D, int dtype, int chunked, void* stream) {
  // the chunked kernel splits the value axis into blocks of JS columns
  const long long nsl = chunked ? (D + JS - 1) / JS : 1;
  if (D < 1 || D > MAXD || S < 0 || Bsz < 1 || H < 1 ||
      (long long)Bsz * H * nsl > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, w, u, s0, y, sout, S, H, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (int)(Bsz * H * nsl);
  if (chunked) {
    const int vec = D % 8 == 0 && aligned16(r) && aligned16(k) &&
                    aligned16(v) && aligned16(w) ? 1 : 0;
    return dtype == 0 ? launch_chunked<bf16>(a, grid, vec, s)
                      : launch_chunked<float>(a, grid, vec, s);
  }
  return dtype == 0 ? launch_seq<bf16>(a, grid, s)
                    : launch_seq<float>(a, grid, s);
}

// The gradient of rwkv6_scan_fwd, the sequential walk in f32 for both
// dtypes: r, k, v, w, u, s0 as there; dy (B,S,H,D) contiguous in r's
// dtype; dsT (B,H,D,D) f32, the final state's gradient, or null for
// zeros.  Writes dr, dk, dv, dw (B,S,H,D) contiguous in r's dtype, du
// (H,D) and ds0 (B,H,D,D) f32.  scratch holds, in f32 and in this order,
// with nsl = ceil(D / 32), NV = 2 for D <= 64 else 4, grid = B H nsl: the
// checkpoints (grid ceil(S / 8) NV 1024), the partial dv (B S H nsl D) and
// du (B H D); every float of it is written before it is read.  Returns
// the CUDA error of the launches (0 on success).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const float* u, const float* s0,
                              const void* dy, const float* dsT, void* dr,
                              void* dk, void* dv, void* dw, float* du,
                              float* ds0, float* scratch, int Bsz, int S,
                              int H, int D, int dtype, void* stream) {
  const int nsl = (D + RB_ROWS - 1) / RB_ROWS, NV = D <= 64 ? 2 : 4;
  if (D < 1 || D > MAXD || S < 0 || Bsz < 1 || H < 1 ||
      (long long)Bsz * H * nsl > 0x7fffffffLL || (dtype != 0 && dtype != 1) ||
      !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)Bsz * H * nsl;
  float4* ckpt = reinterpret_cast<float4*>(scratch);
  float* dv_part = scratch + rb_ckpt_floats(grid, S, NV);
  float* du_part = dv_part + (long long)Bsz * S * H * nsl * D;
  const BwdArgs a{r, k, v, w, u, s0, dy, dsT, dr, dk, dw, ds0, ckpt,
                  dv_part, du_part, S, H, D, nsl, (S + RB_K - 1) / RB_K};
  const int es = dtype == 0 ? 2 : 4;
  const int vec = D * es % 16 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(w) && aligned16(dy) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      dtype == 0 ? launch_bwd<bf16>(a, Bsz, (int)grid, vec, dv, du, s)
                 : launch_bwd<float>(a, Bsz, (int)grid, vec, dv, du, s);
  if (!err) ++g_bwd_launches[vec];
  return err;
}

// The launches of rwkv6_bwd_scan so far in this process that staged r, k,
// v, w and dy by 16-byte copies (vec 1: D times the element's bytes a
// multiple of 16, every pointer 16-byte aligned) or element by element
// (vec 0).
extern "C" int rwkv6_bwd_scan_launches(int vec) {
  return (int)g_bwd_launches[vec ? 1 : 0];
}
