// Grouped (per-expert) matmul for MoE FFNs, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/moe_gmm.py, `moe_gmm` (the Pallas `_kernel`,
// pallas_call at :74).  Semantics are those of
// repro_torch/kernels/ref.py::moe_gmm_ref:
//
//   out[i] = x[i] @ w[ids[i]]   (f32 accumulation, written in x's dtype)
//
// with x (T, K), w (E, K, N), ids (T,) int32 in any order; a row whose id
// lies outside [0, E) is zero.
//
// What bounds it on an H100: bytes at decode and at granite-moe's prefill.
// A prefill launch (16,384 rows, K = 1536, N = 512, E = 40, bf16) reads
// x and w once and writes out: ~130 MB, 0.039 ms at 3.35 TB/s, against
// 25.8 GFLOP, 0.026 ms at 989 TFLOP/s.  A decode launch (32 rows over ~24
// experts) reads those experts' weights, ~38 MB, ~0.011 ms.
//
// What the design does about it, in this first version:
//
// - A plan kernel (one block) counting-sorts the rows by expert on the
//   device: per-expert row offsets, per-expert tile offsets and the
//   permutation.  So any order of ids is right, sorted ids need no
//   special case, and the host never learns the group sizes (no sync).
//   Ids outside [0, E) go to an extra bucket E whose tiles write zeros.
// - The grouped matmul launches one block per (row tile of one expert,
//   column tile of N).  The grid is sized by the bound ceil(T/64) + E + 1
//   on the number of row tiles, known on the host; blocks past the real
//   count exit.  Each block reads only its expert's weights, so a launch
//   reads each present expert's w once per row tile: once at decode,
//   where most experts hold one or two rows, and about seven times (from
//   L2, mostly) at prefill, where each holds ~410.
//   At decode that gives ~24 row tiles x N/64 column tiles, 192 or 576
//   blocks, not the 4-8 that (128-row tile x N tile) would give.
// - No padding: rows, K and N are masked at the edges; 16-byte vector
//   loads where K and N are multiples of 8, element loads otherwise.
// - bf16 runs on the tensor cores through `nvcuda::wmma` (16x16x16 bf16
//   fragments, f32 accumulators): 64x64 output tile, 4 warps of 32x32, K
//   in steps of 32 staged in shared memory, the next step's loads held in
//   registers while the current one multiplies.  f32 runs on the FMA
//   pipes (64x64 tile, 256 threads of 4x4 outputs) in full f32.
//   wgmma and TMA are later work.
//
// Every row's output is the same dot products in the same order whatever
// its tile or neighbours, so the result is bit-reproducible although the
// plan's atomics order the rows within an expert differently each run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int MAXE = 1024;          // largest E (E + 1 buckets in shared)
constexpr int PLAN_NT = 1024;
constexpr int BM = 64;              // rows of a tile (all of one expert)
constexpr int BN = 64;              // columns of a tile

// --------------------------------------------------------------------------
// plan: counting sort of the rows by expert
// --------------------------------------------------------------------------

// off[b], b in [0, E]: first slot of bucket b in perm; off[E+1] = T.
// toff[b]: first row tile of bucket b; toff[E+1] = the number of tiles.
// perm[off[b] .. off[b+1]) holds the rows of bucket b (bucket E: ids out
// of range), in an order that may change from run to run.
__global__ void __launch_bounds__(PLAN_NT) plan_kernel(
    const int* __restrict__ ids, int T, int E, int* __restrict__ perm,
    int* __restrict__ off, int* __restrict__ toff) {
  __shared__ int cnt[MAXE + 1];
  __shared__ int cur[MAXE + 1];
  const int nb = E + 1;
  for (int b = threadIdx.x; b < nb; b += PLAN_NT) cnt[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += PLAN_NT) {
    const int e = ids[i];
    atomicAdd(&cnt[(e >= 0 && e < E) ? e : E], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // warp 0 scans rows and tiles: each lane a run of buckets, then a
    // shuffle scan of the lanes' totals
    const int lane = threadIdx.x;
    const int per = (nb + 31) / 32;
    const int b0 = min(lane * per, nb), b1 = min(b0 + per, nb);
    int rows = 0, tiles = 0;
    for (int b = b0; b < b1; ++b) {
      rows += cnt[b];
      tiles += (cnt[b] + BM - 1) / BM;
    }
    int r_inc = rows, t_inc = tiles;
    for (int d = 1; d < 32; d <<= 1) {
      const int r = __shfl_up_sync(0xffffffffu, r_inc, d);
      const int t = __shfl_up_sync(0xffffffffu, t_inc, d);
      if (lane >= d) {
        r_inc += r;
        t_inc += t;
      }
    }
    int r_run = r_inc - rows, t_run = t_inc - tiles;
    for (int b = b0; b < b1; ++b) {
      off[b] = r_run;
      toff[b] = t_run;
      cur[b] = r_run;
      r_run += cnt[b];
      t_run += (cnt[b] + BM - 1) / BM;
    }
    if (lane == 31) {
      off[nb] = r_inc;
      toff[nb] = t_inc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += PLAN_NT) {
    const int e = ids[i];
    perm[atomicAdd(&cur[(e >= 0 && e < E) ? e : E], 1)] = i;
  }
}

// The block's row tile: its bucket e (E for ids out of range) and its
// rows, -1 past the end.  Returns the bucket, or -1 if the block has no
// tile.  Call from every thread; ends with __syncthreads.
__device__ int block_tile(const int* __restrict__ perm,
                          const int* __restrict__ off,
                          const int* __restrict__ toff, int E, int* rows,
                          int* s_e) {
  const int t = blockIdx.x;
  if (threadIdx.x == 0) {
    int e = -1;
    if (t < toff[E + 1]) {
      // the largest bucket whose first tile is at or before t
      int lo = 0, hi = E;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (toff[mid] <= t) lo = mid;
        else hi = mid - 1;
      }
      e = lo;
    }
    *s_e = e;
  }
  __syncthreads();
  const int e = *s_e;
  if (e >= 0) {
    const int r0 = off[e] + (t - toff[e]) * BM;
    const int n = min(BM, off[e + 1] - r0);
    for (int i = threadIdx.x; i < BM; i += blockDim.x)
      rows[i] = i < n ? perm[r0 + i] : -1;
  }
  __syncthreads();
  return e;
}

template <typename T>
__device__ void write_zero_rows(T* out, const int* rows, int N, int n0) {
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = rows[i / BN], n = n0 + i % BN;
    if (r >= 0 && n < N) out[(long long)r * N + n] = T(0.0f);
  }
}

// --------------------------------------------------------------------------
// bf16: tensor cores through wmma
// --------------------------------------------------------------------------

constexpr int WNT = 128;            // 4 warps, 2 x 2 of 32 x 32 outputs
constexpr int WBK = 32;             // K per stage
constexpr int LDA = WBK + 8;        // shared strides, padded (multiples of 8)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int AV = BM * WBK / 8 / WNT;   // 16-byte vectors per thread: A
constexpr int BV = WBK * BN / 8 / WNT;   // and B

// 8 bf16 of row `src` from column k, zero past `lim`
template <bool VEC>
__device__ __forceinline__ uint4 load8(const uint16_t* src, int k, int lim) {
  if (VEC && k + 8 <= lim) return *reinterpret_cast<const uint4*>(src + k);
  uint16_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = k + j < lim ? src[k + j] : 0;
  uint4 u;
  u.x = v[0] | (unsigned)v[1] << 16;
  u.y = v[2] | (unsigned)v[3] << 16;
  u.z = v[4] | (unsigned)v[5] << 16;
  u.w = v[6] | (unsigned)v[7] << 16;
  return u;
}

template <bool VEC>
__global__ void __launch_bounds__(WNT) gmm_bf16_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
    bf16* __restrict__ out, const int* __restrict__ perm,
    const int* __restrict__ off, const int* __restrict__ toff, int K, int N,
    int E) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[WBK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ int rows[BM];
  __shared__ int s_e;

  const int e = block_tile(perm, off, toff, E, rows, &s_e);
  if (e < 0) return;
  const int n0 = blockIdx.y * BN;
  if (e == E) {
    write_zero_rows(out, rows, N, n0);
    return;
  }
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  const uint16_t* we = w + (long long)e * K * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[AV], rb[BV];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * WNT;
      const int r = idx / (WBK / 8), c = idx % (WBK / 8) * 8;
      const int row = rows[r];
      ra[v] = row >= 0 ? load8<VEC>(x + (long long)row * K, k0 + c, K)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * WNT;
      const int kr = idx / (BN / 8), c = idx % (BN / 8) * 8;
      rb[v] = k0 + kr < K ? load8<VEC>(we + (long long)(k0 + kr) * N, n0 + c,
                                       N)
                          : make_uint4(0, 0, 0, 0);
    }
  };

  if (K > 0) fetch(0);
  for (int k0 = 0; k0 < K; k0 += WBK) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * WNT;
      *reinterpret_cast<uint4*>(&As[idx / (WBK / 8) * LDA +
                                    idx % (WBK / 8) * 8]) = ra[v];
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * WNT;
      *reinterpret_cast<uint4*>(&Bs[idx / (BN / 8) * LDB +
                                    idx % (BN / 8) * 8]) = rb[v];
    }
    __syncthreads();
    if (k0 + WBK < K) fetch(k0 + WBK);
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wr * 32 + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wc * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                   acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wr * 32 + i * 16) * LDC + wc * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += WNT) {
    const int r = rows[i / BN], n = n0 + i % BN;
    if (r >= 0 && n < N)
      out[(long long)r * N + n] = __float2bfloat16(Cs[i / BN * LDC + i % BN]);
  }
}

// --------------------------------------------------------------------------
// f32: FMA pipes, full f32
// --------------------------------------------------------------------------

constexpr int FNT = 256;            // 16 x 16 threads of 4 x 4 outputs
constexpr int FBK = 16;             // K per stage

__global__ void __launch_bounds__(FNT) gmm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, const int* __restrict__ perm,
    const int* __restrict__ off, const int* __restrict__ toff, int K, int N,
    int E) {
  __shared__ float As[FBK][BM + 4];      // transposed: As[k][row]
  __shared__ float Bs[FBK][BN + 4];
  __shared__ int rows[BM];
  __shared__ int s_e;

  const int e = block_tile(perm, off, toff, E, rows, &s_e);
  if (e < 0) return;
  const int n0 = blockIdx.y * BN;
  if (e == E) {
    write_zero_rows(out, rows, N, n0);
    return;
  }
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* we = w + (long long)e * K * N;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int v = 0; v < BM * FBK / FNT; ++v) {
      const int idx = tid + v * FNT;
      const int r = idx / FBK, kk = idx % FBK, row = rows[r];
      As[kk][r] = row >= 0 && k0 + kk < K ? x[(long long)row * K + k0 + kk]
                                          : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < FBK * BN / FNT; ++v) {
      const int idx = tid + v * FNT;
      const int kr = idx / BN, c = idx % BN;
      Bs[kr][c] = k0 + kr < K && n0 + c < N
                      ? we[(long long)(k0 + kr) * N + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rows[ty * 4 + i];
    if (r < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(long long)r * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// x: (T, K) contiguous; w: (E, K, N) contiguous; ids: (T,) int32; out:
// (T, N) contiguous, in x's dtype; perm (T,), off (E + 2,) and toff
// (E + 2,) int32 scratch on the device.  dtype: 0 = bf16, 1 = f32 (x, w
// and out).  E at most 1024.  Launches the plan kernel, then the grouped
// matmul, on `stream`.  Returns the CUDA error of the launches (0 on
// success).
extern "C" int moe_gmm_fwd(const void* x, const void* w, const int* ids,
                           void* out, int* perm, int* off, int* toff, int T,
                           int K, int N, int E, int dtype, void* stream) {
  if (T < 0 || K < 0 || N < 0 || E < 1 || E > MAXE ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  plan_kernel<<<1, PLAN_NT, 0, s>>>(ids, T, E, perm, off, toff);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((T + BM - 1) / BM + E + 1, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    gmm_f32_kernel<<<grid, FNT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), perm, off, toff, K, N, E);
    return (int)cudaGetLastError();
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w);
  const bool vec = K % 8 == 0 && N % 8 == 0 && align % 16 == 0;
  auto xs = static_cast<const uint16_t*>(x);
  auto ws = static_cast<const uint16_t*>(w);
  auto os = static_cast<bf16*>(out);
  if (vec)
    gmm_bf16_kernel<true><<<grid, WNT, 0, s>>>(xs, ws, os, perm, off, toff,
                                               K, N, E);
  else
    gmm_bf16_kernel<false><<<grid, WNT, 0, s>>>(xs, ws, os, perm, off, toff,
                                                K, N, E);
  return (int)cudaGetLastError();
}
