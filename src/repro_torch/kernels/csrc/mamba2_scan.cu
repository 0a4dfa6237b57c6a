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
// ~68 MB, ~20 us at 3.35 TB/s.  At decode (S=1) reading and writing the
// state is almost all of it.  The chunked kernel below runs at ~3.5x that
// bound, held back by the instructions its threads issue between the
// products, not by the tensor cores or the bytes (PERF.md).
//
// Two forward kernels, and the backward's two paths at the end of the
// file; the wrapper picks a forward kernel by dtype and S
// (mamba2_scan.schedule), a backward path the same way (bwd_schedule):
//
// - mamba2_chunked, bf16 with S >= CK_T: the chunked dual form on the
//   tensor cores, wgmma m64n64k16 with bf16 operands and f32 sums.  One
//   warpgroup per (b, h, slice of CK_PS = 64 rows of P): the chunk's 64
//   steps are wgmma's 64 rows, and rows of the state evolve independently,
//   so the split is exact (448 blocks at the serve shape).  The block
//   walks the chunks of CK_T steps in order and keeps its (CK_PS, N) f32
//   state in wgmma accumulators between them (no chunk states in device
//   memory).  Per chunk, with s the chunk-local cumsum of dt A (every
//   exponent below is <= 0):
//     y     = exp(s_t) (C @ state^T)
//             + (G o exp(s_t - s_tau) dt_tau [tau <= t]) @ x
//     state <- exp(s_T) state + (x o dt exp(s_T - s_tau))^T @ B
//   with G = C B^T.  Operands in shared memory are 64-row panels in the
//   128-byte swizzle: B, C and x by TMA (B serves as the K-major operand
//   of G and the MN-major one of the update), the state and the update's
//   A operand written by the threads; M stays in registers as the A
//   operand of M @ x.  The inputs of chunk c + 1 load while chunk c's y
//   and state go out (one buffer each; a second buffer measured no
//   faster, and the smaller footprint fits 3 blocks an SM).  Layouts TMA
//   cannot take (P or N not a multiple of 8, or unaligned strides) are
//   loaded element by element.  N of 65 to 128 takes two panels; N and P
//   below 64 are zero-padded.  mma.sync m16n8k16 over 4 warps of 32 rows
//   of P (fitting P and N of 16 without padding) measured 1.7x slower.
//   Rounding: B, C and x are bf16 already and enter their products as
//   they are.  The other operands are f32 and each enters as two bf16
//   terms, hi = bf16(v) and lo = bf16(v - hi), the product taken as
//   hi*b + lo*b: M = G o exp(s_t - s_tau) dt_tau (G's f32 accumulators
//   scaled in registers), the state before C @ state^T, and
//   x dt exp(s_T - s_tau) for the update.  One bf16 rounding of these
//   puts some y outside the 2e-2 tolerance, since y's terms are ~10x y
//   (tests/test_torch_scan_chunks.py::
//   test_mamba2_one_bf16_rounding_is_not_enough).
// - mamba2_seq: f32 at every S (the check path: y to 2e-5, which no
//   tensor-core product meets) and bf16 below one chunk, the model's
//   decode step (S = 1) among them.  Sequential f32 FMAs, a block of 128
//   threads per (b, h, slice of 32 rows of P), 4 lanes to a row: each lane
//   owns 16-byte runs of consecutive n, so every warp load of the state
//   covers whole 32-byte sectors, and it issues all of its state loads
//   before any arithmetic.  y_t[p] is summed over the row's 4 lanes by
//   shuffles; SQ_L steps of x, B, C and dt at a time are staged in shared
//   memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "scan_bwd.cuh"

namespace {

constexpr int MAXD = 128;           // largest P and N

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
  const void* x; const float* dt; const float* A; const void* B;
  const void* C; const float* h0; void* y; float* hout;
  int S, H, P, N;
  long long xs_b, xs_s, xs_h;       // strides of x (its last is 1)
  long long bs_b, bs_s, cs_b, cs_s; // strides of B and C (their last is 1)
  unsigned char* img;               // the states pass's chunk states
};

// ------------------------------------------------ sequential: mamba2_seq
constexpr int SQ_NT = 128;          // threads per block
constexpr int SQ_G = 4;             // lanes per state row
constexpr int SQ_ROWS = SQ_NT / SQ_G;  // rows of P per block
constexpr int SQ_L = 16;            // time steps staged at once

// NV: 16-byte runs of n per lane (N <= 16 NV).  Lane g of row p owns
// n = 4 (g + 4 j) + e, j < NV, e < 4.
template <typename T, int NV>
__global__ void __launch_bounds__(SQ_NT) mamba2_seq(Args a, int vec4) {
  __shared__ __align__(16) float sb[SQ_L][MAXD];
  __shared__ __align__(16) float sc[SQ_L][MAXD];
  __shared__ float sx[SQ_L][SQ_ROWS];
  __shared__ float sy[SQ_L][SQ_ROWS];
  __shared__ float sdt[SQ_L];

  const int H = a.H, P = a.P, N = a.N, S = a.S;
  const int nsl = (P + SQ_ROWS - 1) / SQ_ROWS;
  const int bh = blockIdx.x / nsl, p0 = (blockIdx.x % nsl) * SQ_ROWS;
  const int b = bh / H, hh = bh % H;
  const int g = threadIdx.x % SQ_G, r = threadIdx.x / SQ_G;
  const int p = p0 + r;
  const bool row = p < P;
  const long long soff = ((long long)bh * P + p) * N;

  // the state first: every load of this lane in flight before any use
  float4 st[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int n = 4 * (g + SQ_G * j);
    st[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.h0 && row && n < N) {
      const float* src = a.h0 + soff + n;
      if (vec4) {
        st[j] = *reinterpret_cast<const float4*>(src);
      } else {
        st[j].x = src[0];
        if (n + 1 < N) st[j].y = src[1];
        if (n + 2 < N) st[j].z = src[2];
        if (n + 3 < N) st[j].w = src[3];
      }
    }
  }

  const float A = a.A[hh];
  const T* x = static_cast<const T*>(a.x) + b * a.xs_b + hh * a.xs_h + p0;
  const T* Bm = static_cast<const T*>(a.B) + b * a.bs_b;
  const T* Cm = static_cast<const T*>(a.C) + b * a.cs_b;
  const float* dt = a.dt + (long long)b * S * H + hh;
  T* y = static_cast<T*>(a.y) + ((long long)b * S * H + hh) * P + p0;

  for (int t0 = 0; t0 < S; t0 += SQ_L) {
    const int nt = min(SQ_L, S - t0);
    for (int e = threadIdx.x; e < nt * SQ_ROWS; e += SQ_NT) {
      const int tt = e / SQ_ROWS, q = e % SQ_ROWS;
      sx[tt][q] = p0 + q < P ? to_f(x[(t0 + tt) * a.xs_s + q]) : 0.f;
    }
    for (int e = threadIdx.x; e < nt * 16 * NV; e += SQ_NT) {
      const int tt = e / (16 * NV), n = e % (16 * NV);
      sb[tt][n] = n < N ? to_f(Bm[(t0 + tt) * a.bs_s + n]) : 0.f;
      sc[tt][n] = n < N ? to_f(Cm[(t0 + tt) * a.cs_s + n]) : 0.f;
    }
    if (threadIdx.x < nt)
      sdt[threadIdx.x] = dt[(long long)(t0 + threadIdx.x) * H];
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float d = sdt[tt];
      const float decay = expf(d * A);
      const float dx = d * sx[tt][r];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int n = 4 * (g + SQ_G * j);
        const float4 bq = *reinterpret_cast<const float4*>(&sb[tt][n]);
        const float4 cq = *reinterpret_cast<const float4*>(&sc[tt][n]);
        st[j].x = st[j].x * decay + dx * bq.x;
        acc += st[j].x * cq.x;
        st[j].y = st[j].y * decay + dx * bq.y;
        acc += st[j].y * cq.y;
        st[j].z = st[j].z * decay + dx * bq.z;
        acc += st[j].z * cq.z;
        st[j].w = st[j].w * decay + dx * bq.w;
        acc += st[j].w * cq.w;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) sy[tt][r] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nt * SQ_ROWS; e += SQ_NT) {
      const int tt = e / SQ_ROWS, q = e % SQ_ROWS;
      if (p0 + q < P)
        y[(long long)(t0 + tt) * H * P + q] = from_f<T>(sy[tt][q]);
    }
  }

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int n = 4 * (g + SQ_G * j);
    if (!row || n >= N) continue;
    float* dst = a.hout + soff + n;
    if (vec4) {
      *reinterpret_cast<float4*>(dst) = st[j];
    } else {
      dst[0] = st[j].x;
      if (n + 1 < N) dst[1] = st[j].y;
      if (n + 2 < N) dst[2] = st[j].z;
      if (n + 3 < N) dst[3] = st[j].w;
    }
  }
}

template <typename T>
int launch_seq(const Args& a, int grid, int vec4, cudaStream_t s) {
  if (a.N <= 16) mamba2_seq<T, 1><<<grid, SQ_NT, 0, s>>>(a, vec4);
  else if (a.N <= 32) mamba2_seq<T, 2><<<grid, SQ_NT, 0, s>>>(a, vec4);
  else if (a.N <= 64) mamba2_seq<T, 4><<<grid, SQ_NT, 0, s>>>(a, vec4);
  else mamba2_seq<T, 8><<<grid, SQ_NT, 0, s>>>(a, vec4);
  return (int)cudaGetLastError();
}

// ---------------------------------------- chunked, bf16: mamba2_chunked
constexpr int CK_T = 64;            // steps per chunk: wgmma's 64 rows
constexpr int CK_PS = 64;           // rows of P per block
constexpr int CK_NT = 128;          // one warpgroup
constexpr int TILE = 64 * 128;      // bytes of a 64-row x 64-column panel
constexpr int LDY = CK_PS + 8;      // pitch of the y staging tile

// byte offset of element (r, c), c < 64, of a panel of 128-byte rows in the
// 128-byte swizzle of wgmma: the 16-byte chunk c / 8 of row r is stored at
// chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// d (64x64 f32) = (scale_d ? d : 0) + A (64x16, smem, K-major) *
// B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_ss_tb(float* d, uint64_t da,
                                            uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A box of a 4-dimensional tensor through its map into shared memory;
// coordinates innermost first; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of shared memory to global memory by the
// bulk-copy engine, both 16-byte aligned, as one bulk group of this thread
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// 16 bytes at shared address `at` of this block, in block `rank` of its
// cluster (distributed shared memory)
__device__ __forceinline__ float4 ld_cluster4(uint32_t at, int rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(at), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - f.x, b - f.y));
}

// 4-byte asynchronous copy to shared memory; `bytes` is 4, or 0 for a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Shared memory of one block (offsets from a 1024-byte aligned base); the
// operand tiles are panels of 64 rows x 128 bytes in the 128-byte swizzle.
template <int NPN>
struct WgSmem {
  static constexpr int B = 0;                    // [NPN] B as [t][n]
  static constexpr int C = B + NPN * TILE;       // [NPN] C as [t][n]
  static constexpr int X = C + NPN * TILE;       // x as [t][p]
  static constexpr int DH = X + TILE;            // x dt e^(s_T - s_t) as
  static constexpr int DL = DH + TILE;           //   [p][t], hi and lo;
                                                 //   y, [t][LDY] bf16, after
  static constexpr int HH = DL + TILE;           // [NPN] the state as
  static constexpr int HL = HH + NPN * TILE;     //   [p][n], hi and lo
  static constexpr int DT = HL + NPN * TILE;     // [CK_T] dt
  static constexpr int S = DT + CK_T * 4;        // [4][CK_T] cumsum of dt A
  static constexpr int CO = S + 4 * CK_T * 4;    // [4][CK_T] dt e^(s_T - s_t)
  static constexpr int BAR = CO + 4 * CK_T * 4;  // the TMA's mbarrier
  static constexpr int BYTES = BAR + 8;
  static constexpr int TMA_BYTES = (2 * NPN + 1) * TILE;  // a chunk's
  static constexpr int IMG = 2 * NPN * TILE;     // a state's hi, lo image
  static_assert(CK_T * LDY * 2 <= 2 * TILE, "y fits where DH and DL are");
};

// NPN: 64-column panels of N (N <= 64 NPN, zero-padded).  VEC: B, C and x
// come by TMA through map_b, map_c and map_x (P and N multiples of 8,
// strides of 16 bytes), y by 16-byte stores; else element by element.
// STATES: the backward's states pass, which reads no C and writes no y
// and no final state; instead the state entering each chunk goes to
// a.img as the image of its hi and lo tiles in shared memory (2 NPN
// panels, IMG bytes a chunk and block, by one bulk store).
template <int NPN, bool VEC, bool STATES = false>
__global__ void __launch_bounds__(CK_NT)
mamba2_chunked(Args a, const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c,
               const __grid_constant__ CUtensorMap map_x) {
  using L = WgSmem<NPN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sy = reinterpret_cast<bf16*>(sm + L::DH);
  float* sdt = reinterpret_cast<float*>(sm + L::DT);

  const int H = a.H, P = a.P, N = a.N, S = a.S;
  const int nsl = (P + CK_PS - 1) / CK_PS;
  const int bh = blockIdx.x / nsl, p0 = (blockIdx.x % nsl) * CK_PS;
  const int b = bh / H, hh = bh % H;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index, known to the compiler as uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, c = lane & 3;
  const float A = a.A[hh];
  const bf16* x = static_cast<const bf16*>(a.x) + b * a.xs_b +
                  hh * a.xs_h + p0;
  const bf16* Bm = static_cast<const bf16*>(a.B) + b * a.bs_b;
  const bf16* Cm = static_cast<const bf16*>(a.C) + b * a.cs_b;
  const float* dt = a.dt + (long long)b * S * H + hh;
  bf16* y = static_cast<bf16*>(a.y) + ((long long)b * S * H + hh) * P + p0;
  const int nc = (S + CK_T - 1) / CK_T;
  float* ss = reinterpret_cast<float*>(sm + L::S) + warp * CK_T;
  float* sco = reinterpret_cast<float*>(sm + L::CO) + warp * CK_T;
  unsigned char* img = STATES ? a.img + (long long)blockIdx.x * nc * L::IMG
                              : nullptr;
  constexpr int tma_bytes = STATES ? (NPN + 1) * TILE : L::TMA_BYTES;

  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  if constexpr (VEC) {
    if (tid == 0) {
      mbar_init(full, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // one 64 x 64 tile of a row-major (rows, cols) bf16 matrix with row
  // stride ld into a swizzled panel, zeros past rows and cols, element by
  // element: this lane copies chunk lq of rows lr + 16 i, i < 4
  const int lr = tid >> 3, lq = tid & 7;
  auto load_tile = [&](unsigned char* dst, const bf16* src, long long ld,
                       int rows, int cols) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 16 * i;
      const bf16* from = src + r * ld + 8 * lq;
      bf16* to = reinterpret_cast<bf16*>(dst + swz(r, 8 * lq));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        to[k] = r < rows && 8 * lq + k < cols ? from[k]
                                              : __float2bfloat16(0.f);
    }
  };
  // B, C, x and dt of chunk ci into their buffers: the tiles by TMA,
  // issued by thread 0 (zeros past S, N and P), or element by element
  auto load_chunk = [&](int ci) {
    const int t0 = ci * CK_T, rows = min(CK_T, S - t0);
    if constexpr (VEC) {
      if (tid == 0) {
        mbar_expect(full, tma_bytes);
#pragma unroll
        for (int pn = 0; pn < NPN; ++pn) {
          tma_load_3d(sm + L::B + pn * TILE, &map_b, full, 64 * pn, t0, b);
          if constexpr (!STATES)
            tma_load_3d(sm + L::C + pn * TILE, &map_c, full, 64 * pn, t0,
                        b);
        }
        tma_load_4d(sm + L::X, &map_x, full, p0, hh, t0, b);
      }
    } else {
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn) {
        load_tile(sm + L::B + pn * TILE, Bm + t0 * a.bs_s + 64 * pn, a.bs_s,
                  rows, N - 64 * pn);
        if constexpr (!STATES)
          load_tile(sm + L::C + pn * TILE, Cm + t0 * a.cs_s + 64 * pn,
                    a.cs_s, rows, N - 64 * pn);
      }
      load_tile(sm + L::X, x + t0 * a.xs_s, a.xs_s, rows, P - p0);
    }
    if (tid < CK_T) {
      const bool ok = tid < rows;
      cp_async4(sdt + tid, ok ? dt + (long long)(t0 + tid) * H : dt,
                ok ? 4 : 0);
    }
    cp_async_commit();
  };

  // the state, f32, as the accumulators of a 64 x 64 wgmma per panel of N:
  // acc_h[pn][4 j + e] is row p = 16 warp + g + 8 (e / 2), column
  // n = 64 pn + 8 j + 2 c + e % 2
  float acc_h[NPN][32];
#pragma unroll
  for (int pn = 0; pn < NPN; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = p0 + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int n = 64 * pn + 8 * (i >> 2) + 2 * c + (i & 1);
      acc_h[pn][i] = a.h0 && p < P && n < N
                         ? a.h0[((long long)bh * P + p) * N + n] : 0.f;
    }
  // the state into shared memory as [p][n], hi and lo: rows
  // 16 warp + g (+8), whose swizzle is g
  unsigned char* const hrow = sm + (16 * warp + g) * 128 + 4 * c;
  auto store_state = [&]() {
#pragma unroll
    for (int pn = 0; pn < NPN; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int off = pn * TILE + 1024 * hf + ((j ^ g) << 4);
          uint32_t hi, lo;
          split2(acc_h[pn][4 * j + 2 * hf], acc_h[pn][4 * j + 2 * hf + 1],
                 hi, lo);
          *reinterpret_cast<uint32_t*>(hrow + L::HH + off) = hi;
          *reinterpret_cast<uint32_t*>(hrow + L::HL + off) = lo;
        }
  };
  store_state();
  load_chunk(0);

  // wgmma descriptors of the tiles: the base's plus the offset / 16, for
  // K-major operands (16, 1024) and MN-major ones (TILE, 1024)
  const uint64_t dk0 = wg_desc(sm, 16, 1024), dm0 = wg_desc(sm, TILE, 1024);
  auto dk = [&](int off) { return dk0 + (uint64_t)(off >> 4); };
  auto dm = [&](int off) { return dm0 + (uint64_t)(off >> 4); };
  // lane p of this warp's half of P in the update's A operand, and its
  // offsets in x of steps 8 q + k (k < 8) less 1024 q
  const int up = 32 * (warp & 1) + lane;
  int xoff[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) xoff[k] = swz(k, up);

  // one chunk: its inputs arrive during the previous chunk's output
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * CK_T;
    cp_async_wait<0>();
    if constexpr (VEC) mbar_wait(full, ci & 1);
    fence_proxy_async();
    __syncthreads();
    // the state entering this chunk, as stored by store_state
    if constexpr (STATES)
      if (tid == 0)
        bulk_store(img + (long long)ci * L::IMG, sm + L::HH, L::IMG);

    // chunk-local inclusive cumsum of dt A, by every warp for itself: lane
    // l sums steps 2 l and 2 l + 1, then the pair sums are scanned; then
    // the update's factors dt exp(s_T - s_t)
    const float* dtc = sdt;
    {
      const float2 d2 = *reinterpret_cast<const float2*>(&dtc[2 * lane]);
      const float a0 = d2.x * A, a1 = a0 + d2.y * A;
      float inc = a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      const float s0 = inc - a1 + a0, sT = __shfl_sync(0xffffffffu, inc, 31);
      *reinterpret_cast<float2*>(&ss[2 * lane]) = make_float2(s0, inc);
      *reinterpret_cast<float2*>(&sco[2 * lane]) =
          make_float2(d2.x * __expf(sT - s0), d2.y * __expf(sT - inc));
      __syncwarp();
    }
    const float sT = ss[CK_T - 1];

    // the update's A operand, (x o dt e^(s_T - s_t))^T as [p][t], hi and
    // lo: lane p = up, 8 steps t = 8 q + k at a time
    {
      const unsigned char* xs = sm + L::X;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = (warp >> 1) + 2 * i;
        const float4 c0 = *reinterpret_cast<const float4*>(&sco[8 * q]);
        const float4 c1 = *reinterpret_cast<const float4*>(&sco[8 * q + 4]);
        const float co[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = __bfloat162float(*reinterpret_cast<const bf16*>(
                     xs + 1024 * q + xoff[k])) * co[k];
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], h[e], l[e]);
        const int off = up * 128 + ((q ^ (up & 7)) << 4);
        *reinterpret_cast<uint4*>(sm + L::DH + off) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(sm + L::DL + off) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    fence_proxy_async();
    __syncthreads();

    const int cB = L::B;
    float acc_y[32];
    uint32_t mh[4][4], ml[4][4];
    const int ta = 16 * warp + g;
    if constexpr (!STATES) {
      const int cC = L::C;
      // G = C B^T and the inter-chunk C @ state^T (the state as hi + lo),
      // both over K = n
      float gacc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NPN; ++kk) {
        const int off = (kk >> 2) * TILE + (kk & 3) * 32;
        const uint64_t dc = dk(cC + off);
        wgmma_ss<64>(gacc, dc, dk(cB + off), kk > 0);
        wgmma_ss<64>(acc_y, dc, dk(L::HH + off), kk > 0);
        wgmma_ss<64>(acc_y, dc, dk(L::HL + off), 1);
      }
      wg_commit();
      wg_wait0();
      wg_touch(gacc);
      wg_touch(acc_y);

      // y's rows t = 16 warp + g (+8): exp(s_t) C @ state^T, and the
      // intra-chunk factor M = G o exp(s_t - s_tau) dt_tau [tau <= t] as the
      // A fragments of M @ x, hi and lo
      const int tb = ta + 8;
      const float sta = ss[ta], stb = ss[tb];
      {
        const float ea = __expf(sta), eb = __expf(stb);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc_y[4 * j] *= ea;
          acc_y[4 * j + 1] *= ea;
          acc_y[4 * j + 2] *= eb;
          acc_y[4 * j + 3] *= eb;
        }
      }
      // tiles j < 2 warp lie below this warp's rows, j > 2 warp + 1 above
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t* h = &mh[j >> 1][2 * (j & 1)];
        uint32_t* l = &ml[j >> 1][2 * (j & 1)];
        if (j > 2 * warp + 1) {
          h[0] = h[1] = l[0] = l[1] = 0u;
          continue;
        }
        const int tau = 8 * j + 2 * c;
        const float2 sv = *reinterpret_cast<const float2*>(&ss[tau]);
        const float2 dv = *reinterpret_cast<const float2*>(&dtc[tau]);
        float m0 = gacc[4 * j] * __expf(sta - sv.x) * dv.x;
        float m1 = gacc[4 * j + 1] * __expf(sta - sv.y) * dv.y;
        float m2 = gacc[4 * j + 2] * __expf(stb - sv.x) * dv.x;
        float m3 = gacc[4 * j + 3] * __expf(stb - sv.y) * dv.y;
        if (j >= 2 * warp) {
          m0 = tau <= ta ? m0 : 0.f;
          m1 = tau + 1 <= ta ? m1 : 0.f;
          m2 = tau <= tb ? m2 : 0.f;
          m3 = tau + 1 <= tb ? m3 : 0.f;
        }
        split2(m0, m1, h[0], l[0]);
        split2(m2, m3, h[1], l[1]);
      }
    }
    {
      const float eT = __expf(sT);
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_h[pn][i] *= eT;
    }
    // y += M @ x (x the MN-major B operand); the state += the update's A
    // @ B (B the MN-major operand), each over K = the chunk's steps
    const int cX = L::X;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < CK_T / 16; ++kk) {
      if constexpr (!STATES) {
        const uint64_t dx = dm(cX + kk * 2048);
        wgmma_rs(acc_y, mh[kk], dx);
        wgmma_rs(acc_y, ml[kk], dx);
      }
      const uint64_t dh = dk(L::DH + kk * 32), dl = dk(L::DL + kk * 32);
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn) {
        const uint64_t db = dm(cB + pn * TILE + kk * 2048);
        wgmma_ss_tb(acc_h[pn], dh, db);
        wgmma_ss_tb(acc_h[pn], dl, db);
      }
    }
    wg_commit();
    wg_wait0();
    if constexpr (!STATES) wg_touch(acc_y);
#pragma unroll
    for (int pn = 0; pn < NPN; ++pn) wg_touch(acc_h[pn]);

    // every product of the chunk is done and its inputs are free: the next
    // chunk's loads run while y and the state go out
    if constexpr (STATES)
      if (tid == 0) bulk_wait_read();
    fence_proxy_async();
    __syncthreads();
    if (ci + 1 < nc) load_chunk(ci + 1);
    if constexpr (STATES) {
      store_state();
      continue;
    }

    // y in bf16 through this warp's rows of sy, 16 bytes a lane
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<__nv_bfloat162*>(
            &sy[(ta + 8 * hf) * LDY + 8 * j + 2 * c]) =
            __floats2bfloat162_rn(acc_y[4 * j + 2 * hf],
                                  acc_y[4 * j + 2 * hf + 1]);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 16 * warp + (lane >> 3) + 4 * i, pc = 8 * (lane & 7);
      if (t0 + t >= S || p0 + pc >= P) continue;
      bf16* dst = y + (long long)(t0 + t) * H * P + pc;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&sy[t * LDY + pc]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (p0 + pc + e < P) dst[e] = sy[t * LDY + pc + e];
      }
    }
    store_state();
  }

  if constexpr (STATES) {
    if (tid == 0) bulk_wait();
    return;
  }
#pragma unroll
  for (int pn = 0; pn < NPN; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = p0 + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int n = 64 * pn + 8 * (i >> 2) + 2 * c + (i & 1);
      if (p < P && n < N) a.hout[((long long)bh * P + p) * N + n] =
          acc_h[pn][i];
    }
}

// a TMA map of a bf16 tensor of `rank` dims (innermost first, the
// innermost dense), strides in elements, boxes of box[] elements in the
// 128-byte swizzle, zeros out of bounds
bool tile_map(CUtensorMap* map, const void* base, int rank,
              const long long* dims, const long long* strides,
              const int* box) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    if (i > 0) st[i - 1] = (cuuint64_t)strides[i] * 2;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), d, st, bx, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NPN, bool VEC, bool STATES = false>
int launch_chunked_np(const Args& a, int Bsz, int grid, cudaStream_t s) {
  CUtensorMap mb, mc, mx;
  if constexpr (VEC) {
    const long long db[3] = {a.N, a.S, Bsz}, sb[3] = {1, a.bs_s, a.bs_b};
    const long long dc[3] = {a.N, a.S, Bsz}, sc[3] = {1, a.cs_s, a.cs_b};
    const long long dx[4] = {a.P, a.H, a.S, Bsz};
    const long long sx[4] = {1, a.xs_h, a.xs_s, a.xs_b};
    const int box3[3] = {64, CK_T, 1}, box4[4] = {CK_PS, 1, CK_T, 1};
    if (!tile_map(&mb, a.B, 3, db, sb, box3) ||
        !tile_map(&mc, a.C, 3, dc, sc, box3) ||
        !tile_map(&mx, a.x, 4, dx, sx, box4))
      return (int)cudaErrorInvalidValue;
  }
  const int smem = WgSmem<NPN>::BYTES + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      mamba2_chunked<NPN, VEC, STATES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mamba2_chunked<NPN, VEC, STATES><<<grid, CK_NT, smem, s>>>(a, mb, mc, mx);
  return (int)cudaGetLastError();
}

int launch_chunked(const Args& a, int Bsz, int grid, int vec,
                   cudaStream_t s) {
  if (a.N <= 64)
    return vec ? launch_chunked_np<1, true>(a, Bsz, grid, s)
               : launch_chunked_np<1, false>(a, Bsz, grid, s);
  return vec ? launch_chunked_np<2, true>(a, Bsz, grid, s)
             : launch_chunked_np<2, false>(a, Bsz, grid, s);
}

// ------------------------------- backward: mamba2_bwd_scan, mamba2_bwd_sum
// Replaces no TPU kernel: the reference trains through its jnp ref
// (src/repro/kernels/ref.py::mamba2_scan_ref, a lax.scan) and has no
// custom_vjp, so this is the gradient of the Pallas kernel above.  What
// bounds it on an H100: bytes.  At zamba2-7b's training shape (B=4,
// S=1024, H=112, P=N=64, bf16) x, dy and dx are 58.7 MB each and the
// whole call moves ~189 MB, ~0.056 ms at 3.35 TB/s; its f32 FMAs need
// ~0.34 ms on the FMA pipes.  These kernels are the sequential form, for
// f32 (its gradients are held to 1e-4, which no bf16 tensor-core product
// meets) and bf16 below one chunk; bf16 with S >= CK_T takes the chunked
// path below (mamba2_scan.bwd_schedule).
//
// The layout and checkpoint schedule of scan_bwd.cuh; per (b, h), row p of
// the state, with g_t the gradient of h_t (the final state's gradient
// entering at t = S) and a_t = exp(dt_t A):
//   g_t       = dy_t[p] C_t + a_{t+1} g_{t+1}
//   dx_t[p]   = dt_t sum_n g_t[n] B_t[n]
//   ddt_t    += sum_n g_t[n] (x_t[p] B_t[n] + A a_t h_{t-1}[n])
//   dA       += dt_t a_t sum_n g_t[n] h_{t-1}[n]
//   dB_t[n]  += g_t[n] dt_t x_t[p] ,  dC_t[n] += h_t[n] dy_t[p]
//   dh_0      = a_1 g_1
// dx is whole in its row; ddt sums the rows of a head, dB and dC the rows
// of every head, dA also the batch and the steps.  mamba2_bwd_scan writes
// dx, dh_0 and each block's partial sums of dB, dC, ddt (a step each) and
// dA; mamba2_bwd_sum adds the partials in block order and rounds dB and dC
// once to their dtype.  Every sum is f32.

struct BwdArgs {
  const void* x; const float* dt; const float* A; const void* B;
  const void* C; const float* h0; const void* dy; const float* dhT;
  void* dx; float* dh0;
  float4* ckpt; float* dB_part; float* dC_part; float* ddt_part;
  float* dA_part;
  int S, H, P, N, nsl, nck;
  long long xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s;
};

template <int NV>
struct M2BwdSmem {
  float4 sub[BW_NSUB][NV][BW_NT];         // the state before each sub-chunk
  float red[2][BW_WARPS][2 * MAXD + 1];   // a warp's dB, dC and ddt
  float sb[BW_K2][MAXD], sc[BW_K2][MAXD]; // B_t, C_t of the sub-chunk
  float sx[BW_K2][BW_ROWS], sdy[BW_K2][BW_ROWS];
  float sdt[BW_K2];
  float srow[BW_ROWS];
};

// Stage steps [ts, ts + n) of x, B, dt (and, in reverse, C and dy).
template <typename T, int NV>
__device__ __forceinline__ void m2_stage(const BwdArgs& a, M2BwdSmem<NV>& sm,
                                         int b, int hh, int p0, int ts,
                                         int n, bool rev) {
  constexpr int NC = 64 * NV;
  const T* x = static_cast<const T*>(a.x) + b * a.xs_b + hh * a.xs_h + p0;
  const T* dy = static_cast<const T*>(a.dy) +
                ((long long)b * a.S * a.H + hh) * a.P + p0;
  const T* Bm = static_cast<const T*>(a.B) + b * a.bs_b;
  const T* Cm = static_cast<const T*>(a.C) + b * a.cs_b;
  const long long hp = (long long)a.H * a.P;
  for (int e = threadIdx.x; e < n * BW_ROWS; e += BW_NT) {
    const int tt = e / BW_ROWS, q = e % BW_ROWS;
    const bool in = p0 + q < a.P;
    sm.sx[tt][q] = in ? to_f(x[(ts + tt) * a.xs_s + q]) : 0.f;
    if (rev) sm.sdy[tt][q] = in ? to_f(dy[(ts + tt) * hp + q]) : 0.f;
  }
  for (int e = threadIdx.x; e < n * NC; e += BW_NT) {
    const int tt = e / NC, c = e % NC;
    const bool in = c < a.N;
    sm.sb[tt][c] = in ? to_f(Bm[(ts + tt) * a.bs_s + c]) : 0.f;
    if (rev) sm.sc[tt][c] = in ? to_f(Cm[(ts + tt) * a.cs_s + c]) : 0.f;
  }
  if (threadIdx.x < n)
    sm.sdt[threadIdx.x] =
        a.dt[((long long)b * a.S + ts + threadIdx.x) * a.H + hh];
}

// h <- exp(dt A) h + dt x B^T at staged step k
template <int NV>
__device__ __forceinline__ void m2_step(float (&st)[4 * NV],
                                        const M2BwdSmem<NV>& sm, int k,
                                        float A, int g, int r) {
  const float d = sm.sdt[k], decay = expf(d * A), dxv = d * sm.sx[k][r];
#pragma unroll
  for (int i = 0; i < 4 * NV; ++i)
    st[i] = st[i] * decay + dxv * sm.sb[k][bw_col(g, i)];
}

template <typename T, int NV>
__global__ void __launch_bounds__(BW_NT, 1) mamba2_bwd_scan(BwdArgs a) {
  constexpr int E = 4 * NV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<M2BwdSmem<NV>*>(smem_raw);
  const int tid = threadIdx.x, g = tid % BW_G, r = tid / BW_G;
  const int warp = tid / 32, lane = tid % 32;
  const int H = a.H, P = a.P, N = a.N, S = a.S;
  const int bh = blockIdx.x / a.nsl, sl = blockIdx.x % a.nsl;
  const int b = bh / H, hh = bh % H, p0 = sl * BW_ROWS, p = p0 + r;
  const bool row = p < P;
  const float A = a.A[hh];
  const long long hp = (long long)H * P;
  T* dx = static_cast<T*>(a.dx) + ((long long)b * S * H + hh) * P + p0;
  float4* ck = a.ckpt + (long long)blockIdx.x * a.nck * NV * BW_NT + tid;
  const long long nbh = (long long)H * a.nsl, q = (long long)hh * a.nsl + sl;
  const long long srow = ((long long)bh * P + p) * N;

  // forward: the state before each chunk of BW_K1 steps
  float st[E];
  bw_load_row<E>(st, a.h0 ? a.h0 + srow : nullptr, g, N, row);
  for (int c = 0; c < a.nck; ++c) {
    bw_put<E>(ck + (long long)c * NV * BW_NT, st);
    if (c == a.nck - 1) break;
    for (int ts = c * BW_K1; ts < (c + 1) * BW_K1; ts += BW_K2) {
      m2_stage<T, NV>(a, sm, b, hh, p0, ts, BW_K2, false);
      __syncthreads();
      for (int k = 0; k < BW_K2; ++k) m2_step<NV>(st, sm, k, A, g, r);
      __syncthreads();
    }
  }

  // reverse, chunk by chunk from the last
  float carry[E];                   // a_{t+1} g_{t+1}
  bw_load_row<E>(carry, a.dhT ? a.dhT + srow : nullptr, g, N, row);
  float dA_acc = 0.f;
  int buf = 0;
  for (int c = a.nck - 1; c >= 0; --c) {
    const int t0 = c * BW_K1, t1 = min(S, t0 + BW_K1);
    const int nsub = (t1 - t0 + BW_K2 - 1) / BW_K2;
    bw_get<E>(st, ck + (long long)c * NV * BW_NT);
    for (int s = 0; s < nsub; ++s) {
      bw_put<E>(&sm.sub[s][0][tid], st);
      if (s == nsub - 1) break;
      m2_stage<T, NV>(a, sm, b, hh, p0, t0 + s * BW_K2, BW_K2, false);
      __syncthreads();
      for (int k = 0; k < BW_K2; ++k) m2_step<NV>(st, sm, k, A, g, r);
      __syncthreads();
    }
    for (int s = nsub - 1; s >= 0; --s) {
      const int ts = t0 + s * BW_K2, n = min(BW_K2, t1 - ts);
      m2_stage<T, NV>(a, sm, b, hh, p0, ts, n, true);
      __syncthreads();
      float h0s[E], hist[BW_K2][E];
      bw_get<E>(h0s, &sm.sub[s][0][tid]);
#pragma unroll
      for (int i = 0; i < E; ++i) st[i] = h0s[i];
#pragma unroll
      for (int k = 0; k < BW_K2; ++k) {
        if (k < n) m2_step<NV>(st, sm, k, A, g, r);
#pragma unroll
        for (int i = 0; i < E; ++i) hist[k][i] = st[i];
      }
#pragma unroll
      for (int k = BW_K2 - 1; k >= 0; --k) {
        if (k >= n) continue;
        const float d = sm.sdt[k], decay = expf(d * A);
        const float xp = sm.sx[k][r], dyp = sm.sdy[k][r];
        float sgb = 0.f, sgh = 0.f, pb[E], pc[E];
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int col = bw_col(g, i);
          const float gv = dyp * sm.sc[k][col] + carry[i];
          const float hprev = k ? hist[k - 1][i] : h0s[i];
          sgb += gv * sm.sb[k][col];
          sgh += gv * hprev;
          pb[i] = gv * (d * xp);
          pc[i] = hist[k][i] * dyp;
          carry[i] = decay * gv;
        }
        sgb = bw_row_sum(sgb);
        sgh = bw_row_sum(sgh);
        const int t = ts + k;
        if (g == 0 && row) dx[t * hp + r] = from_f<T>(d * sgb);
        dA_acc += d * decay * sgh;
        const float ddt_rows = bw_pair_sum(xp * sgb + A * decay * sgh);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          pb[i] = bw_pair_sum(pb[i]);
          pc[i] = bw_pair_sum(pc[i]);
        }
        if (lane < BW_G) {
#pragma unroll
          for (int i = 0; i < E; ++i) {
            const int col = bw_col(g, i);
            sm.red[buf][warp][col] = pb[i];
            sm.red[buf][warp][MAXD + col] = pc[i];
          }
        }
        if (lane == 0) sm.red[buf][warp][2 * MAXD] = ddt_rows;
        __syncthreads();
        const long long bt = (long long)b * S + t;
        if (tid < 2 * N) {
          const bool isb = tid < N;
          const int col = isb ? tid : tid - N;
          float acc = 0.f;
          for (int w = 0; w < BW_WARPS; ++w)
            acc += sm.red[buf][w][isb ? col : MAXD + col];
          (isb ? a.dB_part : a.dC_part)[(bt * nbh + q) * N + col] = acc;
        } else if (tid == BW_NT - 1) {
          float acc = 0.f;
          for (int w = 0; w < BW_WARPS; ++w) acc += sm.red[buf][w][2 * MAXD];
          a.ddt_part[bt * nbh + q] = acc;
        }
        buf ^= 1;
      }
    }
  }

  bw_store_row<E>(carry, a.dh0 + srow, g, N, row);
  if (g == 0) sm.srow[r] = dA_acc;
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int i = 0; i < BW_ROWS; ++i) acc += sm.srow[i];
    a.dA_part[blockIdx.x] = acc;
  }
}

// dB, dC (B,S,N) in T, ddt (B,S,H) and dA (H,) f32: the partials in block
// order (dB and dC `parts` a step: one a block, or one a cluster)
template <typename T>
__global__ void mamba2_bwd_sum(BwdArgs a, int Bsz, void* dB, void* dC,
                               float* ddt, float* dA, int parts) {
  const long long nbsn = (long long)Bsz * a.S * a.N;
  const long long nbsh = (long long)Bsz * a.S * a.H;
  const long long total = 2 * nbsn + nbsh + a.H;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (e < 2 * nbsn) {
      const bool isc = e >= nbsn;
      const long long f = isc ? e - nbsn : e, bt = f / a.N;
      const float* part = (isc ? a.dC_part : a.dB_part) + bt * parts * a.N +
                          f % a.N;
      for (int j = 0; j < parts; ++j) acc += part[(long long)j * a.N];
      static_cast<T*>(isc ? dC : dB)[f] = from_f<T>(acc);
    } else if (e < 2 * nbsn + nbsh) {
      const long long f = e - 2 * nbsn;
      for (int j = 0; j < a.nsl; ++j) acc += a.ddt_part[f * a.nsl + j];
      ddt[f] = acc;
    } else {
      const int h = (int)(e - 2 * nbsn - nbsh);
      for (int b = 0; b < Bsz; ++b)
        for (int j = 0; j < a.nsl; ++j)
          acc += a.dA_part[((long long)b * a.H + h) * a.nsl + j];
      dA[h] = acc;
    }
  }
}

template <typename T, int NV>
int launch_bwd_nv(const BwdArgs& a, int grid, cudaStream_t s) {
  const int smem = (int)sizeof(M2BwdSmem<NV>);
  const cudaError_t err = cudaFuncSetAttribute(
      mamba2_bwd_scan<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  mamba2_bwd_scan<T, NV><<<grid, BW_NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const BwdArgs& a, int Bsz, int grid, void* dB, void* dC,
               float* ddt, float* dA, cudaStream_t s) {
  const int err = a.N <= 64 ? launch_bwd_nv<T, 1>(a, grid, s)
                            : launch_bwd_nv<T, 2>(a, grid, s);
  if (err) return err;
  const long long total = 2LL * Bsz * a.S * a.N +
                          (long long)Bsz * a.S * a.H + a.H;
  const int blocks = (int)(total < 4096 * 256 ? (total + 255) / 256 : 4096);
  mamba2_bwd_sum<T><<<blocks, 256, 0, s>>>(a, Bsz, dB, dC, ddt, dA,
                                           a.H * a.nsl);
  return (int)cudaGetLastError();
}

// ----------------------- backward, bf16 chunked: mamba2_bwd_chunked
// The gradient of mamba2_chunked, for bf16 with S >= CK_T (the training
// shapes; mamba2_scan.bwd_schedule), as its chunked dual form on the
// tensor cores.  Three launches:
//
// 1. The states pass, mamba2_chunked<NPN, VEC, true>: the forward's state
//    walk, writing the state entering each chunk as the image of its hi
//    and lo panels (IMG bytes a chunk and block; 117 MB at zamba2-7b's
//    training shape, the size of the sequential path's checkpoints).
// 2. mamba2_bwd_chunked: one warpgroup per (b, h, slice of CK_PS rows of
//    P), walking the chunks from the last with dh, the gradient of the
//    state leaving the chunk, in wgmma accumulators between them.  Per
//    chunk, with chunk-local t, tau < CK_T, s the cumsum of dt A, L[t, tau]
//    = exp(s_t - s_tau) on tau <= t, G = C B^T, D = dY (dt x)^T, Q = L o G
//    o D and h_in the state entering the chunk:
//      dX~ = (L o G)^T dY + diag(exp(s_T - s)) B dh^T ,  dx = dt dX~
//      dB  = (L o D)^T C + diag(exp(s_T - s) dt) x dh
//      dC  = (L o D) B + diag(exp(s)) dY h_in
//      dh <- exp(s_T) dh + (diag(exp(s)) dY)^T C
//    and da, the gradient of a = dt A, the sum over t >= tau of ds_t:
//      da_tau = sum_{u < tau <= t} Q[t, u] + sum_{t >= tau} exp(s_t)
//               (dY h_in o C)_t 1 + sum_{t < tau} R_t + exp(s_T) <h_in, dh>
//    with R_t = exp(s_T - s_t) dt_t x_t . (B dh^T)_t; then ddt = sum_p x
//    dX~ + A da and dA = sum dt da.  Q's part is summed as a block (each
//    row u of Q^T summed over t >= tau, then the column tau over u < tau)
//    rather than as rowsum(Q) - colsum(Q), a difference of large sums that
//    loses the f32 digits of da.  Every exponent is <= 0; nothing divides
//    by a decay, so dt A down to -100 a step underflows to exact zeros.
//    Eleven 64 x 64 x 64 products a chunk, 18 with the hi + lo pairs: G^T
//    = B C^T, x dY^T (twice: for Q, then again for dB's (L o D)^T, which
//    would otherwise hold 32 more registers a thread through the dX~
//    products) and dY x^T, bf16 operands as they are; then, each as a
//    pair, B dh^T, (L o G)^T dY, x dh, (L o D)^T C, dY h_in, (L o D) B and
//    the update of dh.  Each f32 operand (dh, h_in, L o G, L o D, exp(s)
//    dY) enters as hi + lo bf16 terms, as in the forward: one rounding of
//    any one of them
//    puts some gradient outside the 2e-2 tolerance
//    (tests/test_torch_scan_bwd_chunks.py::
//    test_mamba2_chunk_bwd_one_bf16_rounding_is_not_enough).  B, C, x and
//    dY come by TMA (or element by element, as the forward), the chunk's
//    h_in image by one bulk copy, all on one mbarrier; the loads of the
//    next chunk (the previous one in time) are issued once this chunk's
//    last product is done.  dx is written in bf16.  dB and dC sum over
//    the heads: the blocks of one b form clusters of up to CK_CL = 8
//    (mamba2_scan.bwd_cluster), each block puts its (CK_T, N) f32 dB and
//    dC in shared memory, and after a cluster barrier each sums a CK_T /
//    cl-row slice of them over the cluster's blocks in rank order through
//    distributed shared memory and writes it: one f32 partial a cluster
//    (B S H nsl N / cl each: 14.7 MB at zamba2's shape, against 117 MB one
//    a block).
//    ddt leaves as one partial per block and step, dA one per block.  At
//    N <= 64: ~101 KB of shared memory and ~185 registers a thread, two
//    blocks an SM (448 blocks at the training shape, 1.7 waves).
// 3. mamba2_bwd_sum, as the sequential path's: the partials in order (dB
//    and dC the clusters'), no atomics, so two runs give the same bits.
struct CkBwdArgs {
  const bf16* x; const float* dt; const float* A; const bf16* B;
  const bf16* C; const bf16* dy; const float* dhT;
  const unsigned char* img;
  bf16* dx; float* dh0; float* dB_part; float* dC_part; float* ddt_part;
  float* dA_part;
  int S, H, P, N, nsl, cl;            // cl: blocks a cluster
  long long xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s;
};

// the most blocks a cluster of mamba2_bwd_chunked takes (the portable
// cluster size); the caller picks the cluster (mamba2_scan.bwd_cluster), a
// power of two up to CK_CL that divides the blocks of one b, H nsl
constexpr int CK_CL = 8;

// launches of mamba2_bwd_chunked (with its states pass) by how they load
// B, C, x and dY: [1] by TMA, [0] element by element
long long g_bwd_chunked_launches[2] = {0, 0};

// Shared memory of one block (offsets from a 1024-byte aligned base)
template <int NPN>
struct BwSmem {
  static constexpr int B = 0;                    // [NPN] B as [t][n]
  static constexpr int C = B + NPN * TILE;       // [NPN] C as [t][n]
  static constexpr int X = C + NPN * TILE;       // x as [t][p]
  static constexpr int DY = X + TILE;            // dY as [t][p]
  static constexpr int HI = DY + TILE;           // [2 NPN] h_in as [p][n],
                                                 //   hi then lo; after the
                                                 //   dC products, (exp(s)
                                                 //   dY)^T as [p][t], hi, lo
  static constexpr int DH = HI + 2 * NPN * TILE; // [2 NPN] dh as [p][n]
  static constexpr int DT = DH + 2 * NPN * TILE; // [CK_T] dt
  static constexpr int S = DT + CK_T * 4;        // [4][CK_T] cumsum of dt A
  static constexpr int DAQ = S + 4 * CK_T * 4;   // [4][CK_T] Q's part of da
  static constexpr int ROW = DAQ + 4 * CK_T * 4; // [3][CK_T] R, ddt_dir, zt
  static constexpr int HD = ROW + 3 * CK_T * 4;  // [4] <h_in, dh> by warp
  static constexpr int BAR = HD + 16;            // the loads' mbarrier
  static constexpr int RED = BAR + 16;           // [2][CK_T][64 NPN] f32:
                                                 //   dB, dC, for the cluster
  static constexpr int BYTES = RED + 2 * CK_T * 64 * NPN * 4;
  static constexpr int IMG = 2 * NPN * TILE;     // h_in's image
  static constexpr int TMA_BYTES = (2 * NPN + 2) * TILE;
};

// the sum over the 4 lanes of a quad (a row of the accumulators)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int NPN, bool VEC>
__global__ void __launch_bounds__(CK_NT)
mamba2_bwd_chunked(CkBwdArgs a, const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_c,
                   const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_dy) {
  using L = BwSmem<NPN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* sdt = reinterpret_cast<float*>(sm + L::DT);
  float* sdaq = reinterpret_cast<float*>(sm + L::DAQ);
  float* sR = reinterpret_cast<float*>(sm + L::ROW);
  float* sdir = sR + CK_T;
  float* szt = sR + 2 * CK_T;
  float* shd = reinterpret_cast<float*>(sm + L::HD);

  const int H = a.H, P = a.P, N = a.N, S = a.S, nsl = a.nsl;
  const int bh = blockIdx.x / nsl, sl = blockIdx.x % nsl, p0 = sl * CK_PS;
  const int b = bh / H, hh = bh % H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, c = lane & 3;
  const float A = a.A[hh];
  const long long hp = (long long)H * P;
  const bf16* x = a.x + b * a.xs_b + hh * a.xs_h + p0;
  const bf16* Bm = a.B + b * a.bs_b;
  const bf16* Cm = a.C + b * a.cs_b;
  const bf16* dy = a.dy + ((long long)b * S * H + hh) * P + p0;
  bf16* dx = a.dx + ((long long)b * S * H + hh) * P + p0;
  const float* dt = a.dt + (long long)b * S * H + hh;
  const int nc = (S + CK_T - 1) / CK_T;
  const unsigned char* img = a.img + (long long)blockIdx.x * nc * L::IMG;
  const long long nbh = (long long)H * nsl, q = (long long)hh * nsl + sl;
  float* ss = reinterpret_cast<float*>(sm + L::S) + warp * CK_T;
  float* red = reinterpret_cast<float*>(sm + L::RED);
  // this block's rank in its cluster, and the cluster's index in its b
  const int rank = (int)cluster_rank();
  const long long ncb = nbh / a.cl, cid = q / a.cl;

  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // as mamba2_chunked's: one 64 x 64 tile element by element
  const int lr = tid >> 3, lq = tid & 7;
  auto load_tile = [&](unsigned char* dst, const bf16* src, long long ld,
                       int rows, int cols) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 16 * i;
      const bf16* from = src + r * ld + 8 * lq;
      bf16* to = reinterpret_cast<bf16*>(dst + swz(r, 8 * lq));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        to[k] = r < rows && 8 * lq + k < cols ? from[k]
                                              : __float2bfloat16(0.f);
    }
  };
  // chunk ci's B, C, x, dY (TMA, or element by element), h_in's image
  // (one bulk copy) and dt (zeros past S)
  auto load_chunk = [&](int ci) {
    const int t0 = ci * CK_T, rows = min(CK_T, S - t0);
    if (tid == 0) {
      mbar_expect(full, L::IMG + (VEC ? L::TMA_BYTES : 0));
      bulk_load(sm + L::HI, img + (long long)ci * L::IMG, L::IMG, full);
      if constexpr (VEC) {
#pragma unroll
        for (int pn = 0; pn < NPN; ++pn) {
          tma_load_3d(sm + L::B + pn * TILE, &map_b, full, 64 * pn, t0, b);
          tma_load_3d(sm + L::C + pn * TILE, &map_c, full, 64 * pn, t0, b);
        }
        tma_load_4d(sm + L::X, &map_x, full, p0, hh, t0, b);
        tma_load_4d(sm + L::DY, &map_dy, full, p0, hh, t0, b);
      }
    }
    if constexpr (!VEC) {
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn) {
        load_tile(sm + L::B + pn * TILE, Bm + t0 * a.bs_s + 64 * pn, a.bs_s,
                  rows, N - 64 * pn);
        load_tile(sm + L::C + pn * TILE, Cm + t0 * a.cs_s + 64 * pn, a.cs_s,
                  rows, N - 64 * pn);
      }
      load_tile(sm + L::X, x + t0 * a.xs_s, a.xs_s, rows, P - p0);
      load_tile(sm + L::DY, dy + t0 * hp, hp, rows, P - p0);
    }
    if (tid < CK_T) {
      const bool ok = tid < rows;
      cp_async4(sdt + tid, ok ? dt + (long long)(t0 + tid) * H : dt,
                ok ? 4 : 0);
    }
    cp_async_commit();
  };

  // dh, f32, as the accumulators of a 64 x 64 wgmma per panel of N:
  // acc_dh[pn][4 j + e] is row p = 16 warp + g + 8 (e / 2), column
  // n = 64 pn + 8 j + 2 c + e % 2
  float acc_dh[NPN][32];
#pragma unroll
  for (int pn = 0; pn < NPN; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = p0 + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int n = 64 * pn + 8 * (i >> 2) + 2 * c + (i & 1);
      acc_dh[pn][i] = a.dhT && p < P && n < N
                          ? a.dhT[((long long)bh * P + p) * N + n] : 0.f;
    }
  load_chunk(nc - 1);

  const uint64_t dk0 = wg_desc(sm, 16, 1024), dm0 = wg_desc(sm, TILE, 1024);
  auto dk = [&](int off) { return dk0 + (uint64_t)(off >> 4); };
  auto dm = [&](int off) { return dm0 + (uint64_t)(off >> 4); };
  // this thread's rows of the accumulators, and its byte offset in a
  // [row][64] panel's rows 16 warp + g (+8) (swizzle g)
  const int ua = 16 * warp + g, ub = ua + 8;
  unsigned char* const hrow = sm + ua * 128 + 4 * c;

  // lane p of this warp's half of P in (exp(s) dY)^T
  const int up = 32 * (warp & 1) + lane;
  float dA_acc = 0.f;

  for (int it = 0; it < nc; ++it) {
    const int ci = nc - 1 - it, t0 = ci * CK_T;
    cp_async_wait<0>();
    mbar_wait(full, it & 1);
    fence_proxy_async();
    __syncthreads();

    // chunk-local inclusive cumsum of dt A, by every warp for itself
    {
      const float2 d2 = *reinterpret_cast<const float2*>(&sdt[2 * lane]);
      const float a0 = d2.x * A, a1 = a0 + d2.y * A;
      float inc = a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      *reinterpret_cast<float2*>(&ss[2 * lane]) =
          make_float2(inc - a1 + a0, inc);
      __syncwarp();
    }
    const float sT = ss[CK_T - 1];
    const float sa = ss[ua], sb = ss[ub], da_ = sdt[ua], db_ = sdt[ub];

    // dh into shared memory as [p][n], hi and lo; <h_in, dh> with h_in's
    // image at the same places
    {
      float hd = 0.f;
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int off = pn * TILE + 1024 * hf + ((j ^ g) << 4);
            const float v0 = acc_dh[pn][4 * j + 2 * hf];
            const float v1 = acc_dh[pn][4 * j + 2 * hf + 1];
            uint32_t hi, lo;
            split2(v0, v1, hi, lo);
            *reinterpret_cast<uint32_t*>(hrow + L::DH + off) = hi;
            *reinterpret_cast<uint32_t*>(hrow + L::DH + NPN * TILE + off) =
                lo;
            const float2 ih = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(hrow + L::HI + off));
            const float2 il = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    hrow + L::HI + NPN * TILE + off));
            hd += (ih.x + il.x) * v0 + (ih.y + il.y) * v1;
          }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        hd += __shfl_xor_sync(0xffffffffu, hd, o);
      if (lane == 0) shd[warp] = hd;
    }
    fence_proxy_async();
    __syncthreads();

    // G^T = B C^T and x dY^T, both [tau][t], over K = n and K = p
    float gacc[32], qacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NPN; ++kk) {
      const int off = (kk >> 2) * TILE + (kk & 3) * 32;
      wgmma_ss<64>(gacc, dk(L::B + off), dk(L::C + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64>(qacc, dk(L::X + kk * 32), dk(L::DY + kk * 32), kk > 0);
    wg_commit();
    wg_wait0();
    wg_touch(gacc);
    wg_touch(qacc);

    // rows u = ua, ub (e / 2) and columns t = 8 j + 2 c + e % 2 of the
    // [tau][t] products: L^T = exp(s_t - s_u) on t >= u (tiles j < 2 warp
    // lie left of this warp's rows, where it is 0)
    auto lt = [&](int j, int e, float2 st) {
      const int t = 8 * j + 2 * c + (e & 1), u = e >> 1 ? ub : ua;
      return j >= 2 * warp && t >= u
                 ? __expf((e & 1 ? st.y : st.x) - (e >> 1 ? sb : sa))
                 : 0.f;
    };
    // (L o G)^T becomes the A fragments of (L o G)^T dY, hi and lo; Q^T =
    // (L o G)^T o dt_u (x dY^T) replaces x dY^T in qacc
    uint32_t fgh[4][4], fgl[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 st = *reinterpret_cast<const float2*>(&ss[8 * j + 2 * c]);
      float gm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        gm[e] = gacc[i] * lt(j, e, st);
        qacc[i] = gm[e] * qacc[i] * (e >> 1 ? db_ : da_);
      }
      const int k = j >> 1, f = 2 * (j & 1);
      split2(gm[0], gm[1], fgh[k][f], fgl[k][f]);
      split2(gm[2], gm[3], fgh[k][f + 1], fgl[k][f + 1]);
    }
    // Q's part of da: V[u, tau], row u of Q^T summed over t >= tau (the
    // quad's lanes by an in-order suffix scan, the column groups j from
    // the last), then V's column tau summed over the rows u < tau: this
    // thread's two rows, then the warp's 8 (lanes g, xor 4, 8, 16), then
    // the warps in order in the tail below
    {
      float vcol[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) vcol[k] = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int u = hf ? ub : ua;
        float after = 0.f;
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          const float q1 = qacc[4 * j + 2 * hf + 1];
          const float ps = qacc[4 * j + 2 * hf] + q1;
          float inc = ps;
          float y = __shfl_down_sync(0xffffffffu, inc, 1);
          if (c < 3) inc += y;
          y = __shfl_down_sync(0xffffffffu, inc, 2);
          if (c < 2) inc += y;
          float excl = __shfl_down_sync(0xffffffffu, inc, 1);
          if (c == 3) excl = 0.f;
          const float tot = __shfl_sync(0xffffffffu, inc, lane & ~3);
          const float base = after + excl;
          const int t = 8 * j + 2 * c;
          if (u < t) vcol[2 * j] += base + ps;
          if (u < t + 1) vcol[2 * j + 1] += base + q1;
          after += tot;
        }
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float v = vcol[k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        vcol[k] = v;
      }
      if (lane < 4) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(&sdaq[warp * CK_T + 8 * j + 2 * c]) =
              make_float2(vcol[2 * j], vcol[2 * j + 1]);
      }
    }

    // dX~ [tau][p]: exp(s_T - s_tau) B dh^T (dh as hi + lo), then R_tau =
    // dt_tau x_tau . that; then += (L o G)^T dY, over K = t
    {
      const float ea = __expf(sT - sa), eb = __expf(sT - sb);
      float acc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NPN; ++kk) {
        const int off = (kk >> 2) * TILE + (kk & 3) * 32;
        const uint64_t db = dk(L::B + off);
        wgmma_ss<64>(acc, db, dk(L::DH + off), kk > 0);
        wgmma_ss<64>(acc, db, dk(L::DH + NPN * TILE + off), 1);
      }
      wg_commit();
      wg_wait0();
      wg_touch(acc);
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  hrow + L::X + 1024 * hf + ((j ^ g) << 4)));
          const float e = hf ? eb : ea;
          float* v = &acc[4 * j + 2 * hf];
          v[0] *= e;
          v[1] *= e;
          (hf ? rb : ra) += xv.x * v[0] + xv.y * v[1];
        }
      ra = quad_sum(ra);
      rb = quad_sum(rb);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < CK_T / 16; ++kk) {
        const uint64_t dd = dm(L::DY + kk * 2048);
        wgmma_rs(acc, fgh[kk], dd);
        wgmma_rs(acc, fgl[kk], dd);
      }
      wg_commit();
      wg_wait0();
      wg_touch(acc);
      // dx = dt dX~ in bf16; ddt's direct part sum_p x dX~
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int u = hf ? ub : ua;
        const float du = hf ? db_ : da_;
        const bool row = t0 + u < S;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  hrow + L::X + 1024 * hf + ((j ^ g) << 4)));
          const float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
          (hf ? pb : pa) += xv.x * v0 + xv.y * v1;
          const int p = 8 * j + 2 * c;
          bf16* dst = dx + (long long)(t0 + u) * hp + p;
          if (!row) continue;
          if constexpr (VEC) {
            if (p0 + p < P)
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(du * v0, du * v1);
          } else {
            if (p0 + p < P) dst[0] = __float2bfloat16(du * v0);
            if (p0 + p + 1 < P) dst[1] = __float2bfloat16(du * v1);
          }
        }
      }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (c == 0) {
        sR[ua] = da_ * ra;
        sR[ub] = db_ * rb;
        sdir[ua] = pa;
        sdir[ub] = pb;
      }
    }

    // this block's dB (i = 0) or dC (i = 1), rows t, columns n, into
    // red[i][t][n] for the cluster's sum
    auto put_red = [&](int i, const float* acc, int pn) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(
              &red[(i * CK_T + (hf ? ub : ua)) * 64 * NPN + 64 * pn + 8 * j +
                   2 * c]) =
              make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    };

    // dB [tau][n]: exp(s_T - s_tau) dt_tau x dh (dh the MN-major operand,
    // hi + lo), then += (L o D)^T C, over K = t, with (L o D)^T = L^T o
    // dt_u (x dY^T) from x dY^T again (kept from above, it would take 32
    // more registers a thread through the dX~ products)
    {
      uint32_t fdh[4][4], fdl[4][4];
      {
        float acc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<64>(acc, dk(L::X + kk * 32), dk(L::DY + kk * 32), kk > 0);
        wg_commit();
        wg_wait0();
        wg_touch(acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 st =
              *reinterpret_cast<const float2*>(&ss[8 * j + 2 * c]);
          float dd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dd[e] = acc[4 * j + e] * (e >> 1 ? db_ : da_) * lt(j, e, st);
          const int k = j >> 1, f = 2 * (j & 1);
          split2(dd[0], dd[1], fdh[k][f], fdl[k][f]);
          split2(dd[2], dd[3], fdh[k][f + 1], fdl[k][f + 1]);
        }
      }
      const float ea = __expf(sT - sa) * da_, eb = __expf(sT - sb) * db_;
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn) {
        float acc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dxk = dk(L::X + kk * 32);
          wgmma_ss_tb(acc, dxk, dm(L::DH + pn * TILE + kk * 2048), kk > 0);
          wgmma_ss_tb(acc, dxk,
                      dm(L::DH + (NPN + pn) * TILE + kk * 2048), 1);
        }
        wg_commit();
        wg_wait0();
        wg_touch(acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j] *= ea;
          acc[4 * j + 1] *= ea;
          acc[4 * j + 2] *= eb;
          acc[4 * j + 3] *= eb;
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < CK_T / 16; ++kk) {
          const uint64_t dc = dm(L::C + pn * TILE + kk * 2048);
          wgmma_rs(acc, fdh[kk], dc);
          wgmma_rs(acc, fdl[kk], dc);
        }
        wg_commit();
        wg_wait0();
        wg_touch(acc);
        // the cluster's peers have read the last chunk's red
        if (pn == 0 && it > 0) cluster_wait();
        put_red(0, acc, pn);
      }
    }

    // dC [t][n]: exp(s_t) dY h_in (h_in the MN-major operand, hi + lo),
    // then += (L o D) B over K = tau, with L o D from dY x^T; and the dY
    // h_in term of da, exp(s_t) sum_n (dY h_in)[t, n] C[t, n]
    {
      float acc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(acc, dk(L::DY + kk * 32), dk(L::X + kk * 32), kk > 0);
      wg_commit();
      wg_wait0();
      wg_touch(acc);
      // rows t = ua, ub, columns tau: L o D = exp(s_t - s_tau) dt_tau
      // (dY x^T) on tau <= t; tiles j > 2 warp + 1 lie right of the rows
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int tau = 8 * j + 2 * c, k = j >> 1, f = 2 * (j & 1);
        if (j > 2 * warp + 1) {
          fh[k][f] = fh[k][f + 1] = fl[k][f] = fl[k][f + 1] = 0u;
          continue;
        }
        const float2 sv = *reinterpret_cast<const float2*>(&ss[tau]);
        const float2 dv = *reinterpret_cast<const float2*>(&sdt[tau]);
        float m0 = acc[4 * j] * __expf(sa - sv.x) * dv.x;
        float m1 = acc[4 * j + 1] * __expf(sa - sv.y) * dv.y;
        float m2 = acc[4 * j + 2] * __expf(sb - sv.x) * dv.x;
        float m3 = acc[4 * j + 3] * __expf(sb - sv.y) * dv.y;
        if (j >= 2 * warp) {
          m0 = tau <= ua ? m0 : 0.f;
          m1 = tau + 1 <= ua ? m1 : 0.f;
          m2 = tau <= ub ? m2 : 0.f;
          m3 = tau + 1 <= ub ? m3 : 0.f;
        }
        split2(m0, m1, fh[k][f], fl[k][f]);
        split2(m2, m3, fh[k][f + 1], fl[k][f + 1]);
      }
      const float ea = __expf(sa), eb = __expf(sb);
      float za = 0.f, zb = 0.f;
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn) {
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dyk = dk(L::DY + kk * 32);
          wgmma_ss_tb(acc, dyk, dm(L::HI + pn * TILE + kk * 2048), kk > 0);
          wgmma_ss_tb(acc, dyk,
                      dm(L::HI + (NPN + pn) * TILE + kk * 2048), 1);
        }
        wg_commit();
        wg_wait0();
        wg_touch(acc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2 cv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    hrow + L::C + pn * TILE + 1024 * hf + ((j ^ g) << 4)));
            float* v = &acc[4 * j + 2 * hf];
            (hf ? zb : za) += v[0] * cv.x + v[1] * cv.y;
            const float e = hf ? eb : ea;
            v[0] *= e;
            v[1] *= e;
          }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < CK_T / 16; ++kk) {
          const uint64_t dbk = dm(L::B + pn * TILE + kk * 2048);
          wgmma_rs(acc, fh[kk], dbk);
          wgmma_rs(acc, fl[kk], dbk);
        }
        wg_commit();
        wg_wait0();
        wg_touch(acc);
        put_red(1, acc, pn);
      }
      za = quad_sum(za);
      zb = quad_sum(zb);
      if (c == 0) {
        szt[ua] = ea * za;
        szt[ub] = eb * zb;
      }
    }
    // this block's dB and dC are in red for the cluster (summed below)
    cluster_arrive();
    __syncthreads();

    // the tail, by warp 0: da_tau = Q's part (the warps in order) + the dY
    // h_in term summed over t >= tau + R summed over t < tau + exp(s_T)
    // <h_in, dh>; ddt = ddt_dir + A da, and dt da toward dA
    if (warp == 0) {
      const int t = 2 * lane;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        q0 += sdaq[w * CK_T + t];
        q1 += sdaq[w * CK_T + t + 1];
      }
      const float z0 = szt[t], z1 = szt[t + 1];
      float zs = z0 + z1;               // the suffix over lanes >= lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, zs, o);
        if (lane + o < 32) zs += y;
      }
      float zx = __shfl_down_sync(0xffffffffu, zs, 1);
      if (lane == 31) zx = 0.f;
      const float r0 = sR[t], r1 = sR[t + 1];
      float rs = r0 + r1;               // the prefix over lanes <= lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, rs, o);
        if (lane >= o) rs += y;
      }
      float rx = __shfl_up_sync(0xffffffffu, rs, 1);
      if (lane == 0) rx = 0.f;
      const float hd = __expf(sT) * (((shd[0] + shd[1]) + shd[2]) + shd[3]);
      const float da0 = ((q0 + (zx + z1 + z0)) + rx) + hd;
      const float da1 = ((q1 + (zx + z1)) + (rx + r0)) + hd;
      if (t0 + t < S)
        a.ddt_part[((long long)b * S + t0 + t) * nbh + q] =
            sdir[t] + A * da0;
      if (t0 + t + 1 < S)
        a.ddt_part[((long long)b * S + t0 + t + 1) * nbh + q] =
            sdir[t + 1] + A * da1;
      float dsum = sdt[t] * da0 + sdt[t + 1] * da1;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
      dA_acc += dsum;
    }

    // (exp(s_t) dY)^T as [p][t], hi and lo, where h_in was: lane p = up,
    // 8 steps t = 8 q + k at a time
    {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qq = (warp >> 1) + 2 * i;
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = __bfloat162float(*reinterpret_cast<const bf16*>(
                     sm + L::DY + 1024 * qq + swz(k, up))) *
                 __expf(ss[8 * qq + k]);
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], h[e], l[e]);
        const int off = up * 128 + ((qq ^ (up & 7)) << 4);
        *reinterpret_cast<uint4*>(sm + L::HI + off) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(sm + L::HI + TILE + off) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    fence_proxy_async();
    __syncthreads();

    // dh <- exp(s_T) dh + (exp(s) dY)^T C, C the MN-major operand
    {
      const float eT = __expf(sT);
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_dh[pn][i] *= eT;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < CK_T / 16; ++kk) {
        const uint64_t eh = dk(L::HI + kk * 32);
        const uint64_t el = dk(L::HI + TILE + kk * 32);
#pragma unroll
        for (int pn = 0; pn < NPN; ++pn) {
          const uint64_t dc = dm(L::C + pn * TILE + kk * 2048);
          wgmma_ss_tb(acc_dh[pn], eh, dc);
          wgmma_ss_tb(acc_dh[pn], el, dc);
        }
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int pn = 0; pn < NPN; ++pn) wg_touch(acc_dh[pn]);
    }
    // every read of this chunk's tiles is done: the next chunk's loads
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < nc) load_chunk(ci - 1);
    // dB and dC summed over the cluster's blocks in rank order, while the
    // next chunk loads: this block sums rows [rank, rank + 1) CK_T / cl of
    // every block's red and writes them as the cluster's partial
    cluster_wait();
    {
      const int rows = CK_T / a.cl, nq = 16 * NPN;   // float4 a row
      const uint32_t mine = smem_u32(red);
      for (int e = tid; e < 2 * rows * nq; e += CK_NT) {
        const int i = e / (rows * nq), t = rank * rows + e / nq % rows;
        const int n = 4 * (e % nq);
        const uint32_t at = mine + ((i * CK_T + t) * 64 * NPN + n) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < a.cl; ++k) {
          const float4 v = ld_cluster4(at, k);
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
        if (t0 + t >= S || n >= N) continue;
        float* dst = (i ? a.dC_part : a.dB_part) +
                     (((long long)b * S + t0 + t) * ncb + cid) * N + n;
        if constexpr (VEC) {
          *reinterpret_cast<float4*>(dst) = acc;
        } else {
          const float v[4] = {acc.x, acc.y, acc.z, acc.w};
          for (int m = 0; m < 4 && n + m < N; ++m) dst[m] = v[m];
        }
      }
    }
    cluster_arrive();
  }

#pragma unroll
  for (int pn = 0; pn < NPN; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = p0 + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int n = 64 * pn + 8 * (i >> 2) + 2 * c + (i & 1);
      if (p < P && n < N) a.dh0[((long long)bh * P + p) * N + n] =
          acc_dh[pn][i];
    }
  if (tid == 0) a.dA_part[blockIdx.x] = dA_acc;
  // no block leaves while its peers may still read its red
  cluster_wait();
}

template <int NPN, bool VEC>
int launch_bwd_chunked_np(const Args& fa, const CkBwdArgs& a, int Bsz,
                          int grid, cudaStream_t s) {
  int err = launch_chunked_np<NPN, VEC, true>(fa, Bsz, grid, s);
  if (err) return err;
  CUtensorMap mb, mc, mx, mdy;
  if constexpr (VEC) {
    const long long db[3] = {a.N, a.S, Bsz}, sb[3] = {1, a.bs_s, a.bs_b};
    const long long dc[3] = {a.N, a.S, Bsz}, sc[3] = {1, a.cs_s, a.cs_b};
    const long long dx[4] = {a.P, a.H, a.S, Bsz};
    const long long sx[4] = {1, a.xs_h, a.xs_s, a.xs_b};
    const long long sy[4] = {1, a.P, (long long)a.H * a.P,
                             (long long)a.S * a.H * a.P};
    const int box3[3] = {64, CK_T, 1}, box4[4] = {CK_PS, 1, CK_T, 1};
    if (!tile_map(&mb, a.B, 3, db, sb, box3) ||
        !tile_map(&mc, a.C, 3, dc, sc, box3) ||
        !tile_map(&mx, a.x, 4, dx, sx, box4) ||
        !tile_map(&mdy, a.dy, 4, dx, sy, box4))
      return (int)cudaErrorInvalidValue;
  }
  const int smem = BwSmem<NPN>::BYTES + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      mamba2_bwd_chunked<NPN, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(CK_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mamba2_bwd_chunked<NPN, VEC>, a, mb, mc, mx,
                         mdy);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_bwd_chunked(const Args& fa, const CkBwdArgs& a, int Bsz, int grid,
                       int vec, cudaStream_t s) {
  if (a.N <= 64)
    return vec ? launch_bwd_chunked_np<1, true>(fa, a, Bsz, grid, s)
               : launch_bwd_chunked_np<1, false>(fa, a, Bsz, grid, s);
  return vec ? launch_bwd_chunked_np<2, true>(fa, a, Bsz, grid, s)
             : launch_bwd_chunked_np<2, false>(fa, a, Bsz, grid, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (B,S,H,P) with strides (xs_b, xs_s, xs_h, 1); dt: (B,S,H) f32; A:
// (H,) f32; B, C: (B,S,N) with strides (*s_b, *s_s, 1); h0: (B,H,P,N) f32
// or null for zeros; y: (B,S,H,P) contiguous; hout: (B,H,P,N) f32.
// dtype: 0 = bf16, 1 = f32 (x, B, C and y).  chunked: 1 for the chunked
// tensor-core kernel (bf16 only), 0 for the sequential one.  P and N at
// most 128.  Returns the CUDA error of the launch (0 on success).
extern "C" int mamba2_scan_fwd(const void* x, const float* dt, const float* A,
                               const void* B, const void* C, const float* h0,
                               void* y, float* hout, int Bsz, int S, int H,
                               int P, int N, long long xs_b, long long xs_s,
                               long long xs_h, long long bs_b, long long bs_s,
                               long long cs_b, long long cs_s, int dtype,
                               int chunked, void* stream) {
  const long long nsl = chunked ? (P + CK_PS - 1) / CK_PS
                                : (P + SQ_ROWS - 1) / SQ_ROWS;
  if (P < 1 || N < 1 || P > MAXD || N > MAXD || S < 0 || Bsz < 1 || H < 1 ||
      (long long)Bsz * H * nsl > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1) || (chunked && dtype != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{x, dt, A, B, C, h0, y, hout, S, H, P, N,
               xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (int)(Bsz * H * nsl);
  if (chunked) {
    const bool vec = P % 8 == 0 && N % 8 == 0 && xs_b % 8 == 0 &&
                     xs_s % 8 == 0 && xs_h % 8 == 0 && bs_b % 8 == 0 &&
                     bs_s % 8 == 0 && cs_b % 8 == 0 && cs_s % 8 == 0 &&
                     aligned16(x) && aligned16(B) && aligned16(C) &&
                     aligned16(y);
    return launch_chunked(a, Bsz, grid, vec ? 1 : 0, s);
  }
  const int vec4 = N % 4 == 0 && (!h0 || aligned16(h0)) && aligned16(hout);
  return dtype == 0 ? launch_seq<bf16>(a, grid, vec4, s)
                    : launch_seq<float>(a, grid, vec4, s);
}

// The gradient of mamba2_scan_fwd: x, dt, A, B, C, h0 and the strides as
// there; dy (B,S,H,P) contiguous in x's dtype; dhT (B,H,P,N) f32, the
// final state's gradient, or null for zeros.  Writes dx (B,S,H,P) and dB,
// dC (B,S,N), contiguous in x's dtype, ddt (B,S,H) and dA (H,) in f32, and
// dh0 (B,H,P,N) f32.  chunked: 1 for the chunked path (bf16 only: the
// states pass, mamba2_bwd_chunked, mamba2_bwd_sum), 0 for the sequential
// one (mamba2_bwd_scan, mamba2_bwd_sum).  cl: the blocks a cluster of the
// chunked path (a power of two up to CK_CL dividing H nsl), 1 on the
// sequential one.  scratch holds, in f32 and in this order, with grid = B
// H nsl: sequential (nsl = ceil(P / 32), NV = 1 for N <= 64 else 2) the
// checkpoints (grid ceil(S / 64) NV 2048 floats); chunked (nsl = ceil(P /
// 64), NPN = 1 for N <= 64 else 2) the chunk states' images (grid ceil(S
// / 64) NPN 4096 floats); then the partial dB and dC (B S H nsl N each,
// divided on the chunked path by cl), ddt (B S H nsl) and dA (grid).
// Every float of it is written before it is read.  Returns the CUDA error
// of the launches (0 on success).
extern "C" int mamba2_scan_bwd(const void* x, const float* dt, const float* A,
                               const void* B, const void* C, const float* h0,
                               const void* dy, const float* dhT, void* dx,
                               float* ddt, float* dA, void* dB, void* dC,
                               float* dh0, float* scratch, int Bsz, int S,
                               int H, int P, int N, long long xs_b,
                               long long xs_s, long long xs_h, long long bs_b,
                               long long bs_s, long long cs_b, long long cs_s,
                               int dtype, int chunked, int cl,
                               void* stream) {
  const int nsl = chunked ? (P + CK_PS - 1) / CK_PS
                          : (P + BW_ROWS - 1) / BW_ROWS;
  const int NV = N <= 64 ? 1 : 2;
  if (P < 1 || N < 1 || P > MAXD || N > MAXD || S < 0 || Bsz < 1 || H < 1 ||
      (long long)Bsz * H * nsl > 0x7fffffffLL || (dtype != 0 && dtype != 1) ||
      (chunked && (dtype != 0 || S < CK_T)) || !aligned16(scratch) ||
      cl < 1 || cl > (chunked ? CK_CL : 1) || (cl & (cl - 1)) ||
      H * nsl % cl)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)Bsz * H * nsl;
  const long long bshn = (long long)Bsz * S * H * nsl;
  const long long nc = (S + CK_T - 1) / CK_T;
  // dB's and dC's partials: one a block, or on the chunked path one a
  // cluster of cl blocks
  float* dB_part = scratch + (chunked ? grid * nc * NV * (TILE / 2)
                                      : bw_ckpt_floats(grid, S, NV));
  float* dC_part = dB_part + bshn / cl * N;
  float* ddt_part = dC_part + bshn / cl * N;
  float* dA_part = ddt_part + bshn;
  const BwdArgs a{x, dt, A, B, C, h0, dy, dhT, dx, dh0,
                  reinterpret_cast<float4*>(scratch), dB_part, dC_part,
                  ddt_part, dA_part, S, H, P, N, nsl,
                  (S + BW_K1 - 1) / BW_K1, xs_b, xs_s, xs_h, bs_b, bs_s,
                  cs_b, cs_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!chunked)
    return dtype == 0
               ? launch_bwd<bf16>(a, Bsz, (int)grid, dB, dC, ddt, dA, s)
               : launch_bwd<float>(a, Bsz, (int)grid, dB, dC, ddt, dA, s);
  unsigned char* img = reinterpret_cast<unsigned char*>(scratch);
  const Args fa{x, dt, A, B, C, h0, nullptr, nullptr, S, H, P, N,
                xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s, img};
  const CkBwdArgs ca{static_cast<const bf16*>(x), dt, A,
                     static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                     static_cast<const bf16*>(dy), dhT, img,
                     static_cast<bf16*>(dx), dh0, dB_part, dC_part, ddt_part,
                     dA_part, S, H, P, N, nsl, cl, xs_b, xs_s, xs_h, bs_b,
                     bs_s, cs_b, cs_s};
  const bool vec = P % 8 == 0 && N % 8 == 0 && xs_b % 8 == 0 &&
                   xs_s % 8 == 0 && xs_h % 8 == 0 && bs_b % 8 == 0 &&
                   bs_s % 8 == 0 && cs_b % 8 == 0 && cs_s % 8 == 0 &&
                   aligned16(x) && aligned16(B) && aligned16(C) &&
                   aligned16(dy) && aligned16(dx);
  const int err = launch_bwd_chunked(fa, ca, Bsz, (int)grid, vec ? 1 : 0, s);
  if (err) return err;
  ++g_bwd_chunked_launches[vec ? 1 : 0];
  const long long total = 2LL * Bsz * S * N + (long long)Bsz * S * H + H;
  const int blocks = (int)(total < 4096 * 256 ? (total + 255) / 256 : 4096);
  mamba2_bwd_sum<bf16><<<blocks, 256, 0, s>>>(a, Bsz, dB, dC, ddt, dA,
                                              H * nsl / cl);
  return (int)cudaGetLastError();
}

// The launches of mamba2_bwd_chunked so far in this process that loaded
// B, C, x and dY by TMA (vec 1: P and N multiples of 8, strides and
// pointers that TMA takes) or element by element (vec 0).
extern "C" int mamba2_bwd_chunked_launches(int vec) {
  return (int)g_bwd_chunked_launches[vec ? 1 : 0];
}
