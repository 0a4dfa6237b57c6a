// Attention for the serving path: prefill (flash_attention_fwd) and
// single-token decode (decode_attention_fwd), and the prefill's gradient
// for training (flash_attention_bwd), CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` (:90,
// the Pallas `_kernel`, pallas_call at :126) and `decode_attention` (:149,
// which reuses that pallas_call).  Semantics are those of
// repro_torch/kernels/ref.py::attention_ref: GQA (KV head = h / (Hq/Hkv)),
// `scale`, then the tanh logit softcap, then the masks: causal
// `kpos <= q_offset[b] + qpos`, window `kpos > q_offset[b] + qpos - window`,
// `kpos < kv_len[b]`; a row with no valid key writes zeros.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//  * prefill at the served shapes (B=4, S=512, causal, bf16) moves each of
//    q, k, v, o once: granite-8b (Hq/Hkv/D = 32/8/128) 42 MB, 12.5 us,
//    against 8.6 GFLOP, 8.7 us on the tensor cores; zamba2-7b's H layers
//    (32/32/112) 59 MB, 17.5 us; granite-moe (24/8/64) 17 MB, 5.0 us.  The
//    byte and tensor-core bounds are close, so the products must run on
//    the tensor cores and the tiles must come in while they run.
//  * decode reads the valid K/V cache once per step and does ~2 FLOP per
//    byte: granite-8b (B=4, cache 544, Hkv=8, D=128) 8.9 MB, 2.7 us;
//    zamba2-7b (Hkv=32, D=112) 31 MB, 9.3 us.  It is bound by bytes, and by
//    how many SMs are streaming them.
//
// What the design does about it:
//  * bf16 prefill (flash_fwd_bf16), FlashAttention-2's algorithm on
//    Hopper's instructions.  One block per (query head, batch, 64-row q
//    tile): a consumer warpgroup (16 query rows a warp) and a producer
//    warp.  The producer's lane 0 loads Q once and the K/V tiles (32 keys,
//    64 at DP = 64) into a two-stage ring with TMA, in 64-column panels in
//    the 128-byte swizzle; an mbarrier per stage says when a tile has
//    landed and another when the consumers are done with it, so the math
//    warps issue no copies.  S = Q K^T is a wgmma with both operands in
//    shared memory; O += P V is a wgmma with P from registers (the S
//    accumulators after the softmax, rounded to bf16, as FlashAttention
//    does; P never goes through shared memory) and V read as its MN-major
//    operand.  m, l and O stay f32.  The online softmax runs in registers
//    (quad shuffles for the row max, the row sum reduced once at the end;
//    O is rescaled only when a row's max moved).  D is zero-padded
//    to DP = 64, 128 or 256 by TMA's out-of-bounds fill (zamba2's 112 runs
//    at 128).  KV tiles wholly past the causal bound or kv_len, or before
//    the window, are never loaded, and tiles that need no mask skip the
//    mask arithmetic.  The q tile is the slowest grid axis, taken in
//    reverse, so the longest causal tiles are issued first and the last
//    wave holds short ones.
//  * f32 prefill (flash_fwd_f32): full f32 on the FMA pipes, for the f32
//    checks (tensor-core TF32 would not meet them).  Q/K/V tiles are staged
//    as f32; each of 256 threads owns a 4x4 block of scores.
//  * decode, split-KV (decode_partial + decode_combine), both dtypes:
//    block (split, KV head, batch) takes one chunk of the cache (a multiple
//    of the 32-key tile; the wrapper picks the chunk so that about two
//    blocks per SM stream the cache).  It copies each K/V row of its chunk
//    once, 16 bytes a thread with cp.async in the stored dtype
//    (double-buffered, no f32 copy), for all g = Hq/Hkv query heads of its
//    KV head: one warp per head, one key per lane for the scores, the
//    softmax by warp shuffles, P V into registers, all in f32.  It writes
//    an unnormalised partial (acc, m, l); a chunk with no valid key writes
//    m = -inf, l = 0.  decode_combine, one block per (KV head, batch),
//    merges the splits in split order: the same bits on every run, no
//    atomics.  It is launched as a programmatic dependent of the partials,
//    so its launch overlaps them.
//
// The backward (flash_attention_bwd), for training: no kv_len, no q offset.
// No TPU kernel: the reference trains through jax.vjp of its jnp ref; this
// is the gradient of the forward above, in passes that each own the rows
// they write (no float atomics), so every run gives the same bits.
// flash_bwd_delta first writes delta = rowsum(dO o O) and lse log2(e).
//  * bf16, every D: three passes on the tensor cores, each one warpgroup
//    of 64 own rows and a TMA producer warp: flash_bwd_kv_wg<DP, 1> (dV:
//    S^T = K Q^T, P^T, dV += P^T dO), flash_bwd_kv_wg<DP, 0> (dK: S^T and
//    dP^T = V dO^T, dS^T, dK += dS^T Q) and flash_bwd_dq_wg (S = Q K^T, dP
//    = dO V^T, dS, dQ += dS K).  The score products are wgmma from shared
//    memory; P and dS go into the second products as bf16 register
//    fragments (dK and dV, summed over g x Sq rows, take them as a hi + lo
//    pair).  The training shape (B 4, S 1024, 32 / 8 heads, D 128, causal)
//    does 120 GFLOP of products, 0.12 ms at 989 TFLOP/s; at DP <= 128 the
//    f32 scores between the products are most of a tile's time, so they
//    run branch-free (softcap and whole tiles chosen at compile time) and
//    two blocks an SM hide one's scores behind the other's products.
//  * bf16 at 128 < D <= 256 (gemma's head size 256) runs the same passes
//    at DP = 256, one block an SM (BwdWgCfg<256>::BLOCKS).  A pass's 64 x
//    256 f32 accumulator is 128 registers a thread; with a tile's 2 x 32
//    scores and their fragments the passes take 197 (dV), 246 (dK) and
//    232 (dQ) without a spill, past the ~200 that two blocks an SM leave
//    a thread, and the dK pass's K, V and two-stage ring of Q and dO (194
//    KB) fit one block only.  Of the designs that keep two tiles in
//    flight, two consumer warpgroups over a 128-row tile leave no room for
//    a second stage of the ring beside 128 KB of K and V, and halving the
//    output's columns over the grid doubles the score products.  This
//    design reuses the passes whole.  At DP 256 a tile's products take
//    twice as long while its elementwise work stays the same, so the
//    products, not the scores, are most of a tile's time, and one block
//    an SM loses less than it does at DP 128.  gemma3-12b's training shape
//    (B 4, S 1024, 16 / 8 heads, D 256, causal) does the same products as
//    granite-8b's.
//  * f32, every D: flash_bwd_dkdv and flash_bwd_dq on the FMA pipes in f32
//    (the f32 checks cannot take bf16 or TF32 products).
// The library counts its backward launches by path
// (flash_attention_bwd_launches).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// What rounding (a, b) to the bf16 pair `hi` left out, rounded to bf16
__device__ inline uint32_t pack_lo(float a, float b, uint32_t hi) {
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_bf16(a - h.x, b - h.y);
}

// Load 16 bytes of T and widen to f32 in registers.
__device__ inline void load16(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ inline void load16(const float* p, float* out) {
  float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}

__device__ inline void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ inline void store1(float* p, float x) { *p = x; }

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Issue the 16-byte copies of `rows` rows from row0 on of one head of a
// (B, S, H, D) tensor into shared memory (row stride LD elements).  Rows at
// or past `nvalid` and columns at or past D are zero-filled.  D is a
// multiple of 16 / sizeof(T), so a chunk that starts below D ends at or
// below D.
template <typename T, int THREADS>
__device__ inline void copy_tile(T* s, const T* base, int rows, int cols,
                                 int LD, int row0, int nvalid,
                                 long long row_stride, int D) {
  constexpr int V = 16 / sizeof(T);
  const int ch = cols / V;
  for (int i = threadIdx.x; i < rows * ch; i += THREADS) {
    const int r = i / ch;
    const int c = (i % ch) * V;
    const bool ok = r < nvalid && c < D;
    cp_async16(s + r * LD + c,
               ok ? base + (long long)(row0 + r) * row_stride + c : base,
               ok ? 16 : 0);
  }
}

// -------------------------------------------- bf16 prefill: wgmma, TMA

constexpr int GQ = 64;    // query rows per block: one warpgroup, 16 a warp
constexpr int GNT = 128;  // consumer threads per block

// A tile of R rows and DP columns in shared memory as DP / 64 panels of R
// rows x 128 bytes, each panel in the 128-byte swizzle of wgmma (the 16-byte
// chunk c of row r at chunk c ^ (r % 8)); panels start 1024-byte aligned.
template <int DP>
struct WgCfg {
  static constexpr int NP = DP / 64;            // panels
  static constexpr int BK = DP > 64 ? 32 : 64;  // keys per tile
  static constexpr int ST = 2;                  // K/V stages
  static constexpr int Q_BYTES = GQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr size_t smem = 1024 + 2 * ST * KV_BYTES + Q_BYTES;
};

// One 64-column x R-row panel of a (B, S, H, D) tensor through its map,
// into shared memory in the 128-byte swizzle; completes on `bar`.
__device__ inline void tma_panel(void* dst, const CUtensorMap* map,
                                 uint64_t* bar, int d0, int h, int row0,
                                 int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(h), "r"(row0), "r"(b)
      : "memory");
}

// The 64 x BK scores of one warpgroup at key tile kt0, NV = BK / 2 of them
// in this thread (rows qrow and qrow + 8): scale, softcap, masks, then the
// online softmax update of m and l.  Leaves P, rounded to bf16, in pa as
// the A fragments of P V, and the factor for the rows' O in alpha.  Without
// a softcap, m is kept in unscaled units and the scale goes into the
// exponent's multiplier.
template <int NV>
__device__ __forceinline__ void softmax_tile(
    float* s, uint32_t (*pa)[4], float* m, float* l, float* alpha, int kt0,
    bool full, int kend, int qrow, int tq, int causal, int has_window,
    int window, int has_softcap, float softcap, float scale) {
  const float sl2 = has_softcap ? kLog2e : scale * kLog2e;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float x = s[i];
    if (has_softcap) x = tanhf(x * scale / softcap) * softcap;
    if (!full) {
      const int kp = kt0 + (i >> 2) * 8 + 2 * tq + (i & 1);
      const int qp = qrow + ((i >> 1) & 1) * 8;
      bool ok = kp < kend;
      if (causal) ok = ok && kp <= qp;
      if (has_window) ok = ok && kp > qp - window;
      if (!ok) x = -INFINITY;
    }
    s[i] = x;
  }
  // row qrow holds s[4j], s[4j+1]; row qrow + 8 holds s[4j+2], s[4j+3]
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NV / 4; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mnew = fmaxf(m[r], mx);
    // a row with no valid key so far keeps O = l = 0 and alpha = 1
    alpha[r] = mnew == -INFINITY ? 1.f : exp2f((m[r] - mnew) * sl2);
    mb[r] = mnew == -INFINITY ? 0.f : mnew * sl2;
    m[r] = mnew;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float p = exp2f(fmaf(s[i], sl2, -mb[(i >> 1) & 1]));
    l[(i >> 1) & 1] += p;
    s[i] = p;
  }
#pragma unroll
  for (int kk = 0; kk < NV / 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Block (query head, batch, q tile): one consumer warpgroup of 64 query
// rows and one producer warp whose lane 0 issues the TMA loads of Q and of
// the K/V tiles into a ring of ST stages.  Stage s is full when its bytes
// have landed (full[s]) and free again when every consumer thread has
// arrived on empty[s].  The q tile is the slowest grid axis, taken in
// reverse: the longest causal tiles go first.
template <int DP>
__global__ void __launch_bounds__(GNT + 32)
flash_fwd_bf16(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len,
              int kv_len_all, const int* __restrict__ q_off, int q_off_all,
              int Sq, int Skv, int Hq, int Hkv, int D, int causal,
              int has_window, int window, int has_softcap, float softcap,
              float scale, float* __restrict__ lse) {
  using C = WgCfg<DP>;
  constexpr int NP = C::NP;
  constexpr int ST = C::ST;
  constexpr int BK = C::BK;
  constexpr int NV = BK / 2;  // scores of a thread per tile
  extern __shared__ __align__(16) unsigned char wsm[];
  __shared__ uint64_t full[ST], empty[ST], qbar;
  unsigned char* base = wsm + ((1024 - (smem_u32(wsm) & 1023)) & 1023);
  unsigned char* sK = base;                   // [ST][KV_BYTES]
  unsigned char* sV = sK + ST * C::KV_BYTES;  // [ST][KV_BYTES]
  unsigned char* sQ = sV + ST * C::KV_BYTES;  // [Q_BYTES]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * GQ;
  const int hk = h / (Hq / Hkv);
  const int qoff = q_off ? q_off[b] : q_off_all;
  int kend = min(kv_len ? kv_len[b] : kv_len_all, Skv);
  if (causal) kend = min(kend, qoff + min(q0 + GQ, Sq));
  int kbeg = 0;
  if (has_window) kbeg = max(0, qoff + q0 - window + 1) / BK * BK;
  const int nt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GNT);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= GNT) {  // the producer warp
    if (threadIdx.x == GNT && nt > 0) {
      mbar_expect(&qbar, C::Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_panel(sQ + p * GQ * 128, &map_q, &qbar, 64 * p, h, q0, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        mbar_expect(&full[s], 2 * C::KV_BYTES);
        for (int p = 0; p < NP; ++p) {
          tma_panel(sK + s * C::KV_BYTES + p * BK * 128, &map_k, &full[s],
                    64 * p, hk, kbeg + t * BK, b);
          tma_panel(sV + s * C::KV_BYTES + p * BK * 128, &map_v, &full[s],
                    64 * p, hk, kbeg + t * BK, b);
        }
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int qrow = qoff + q0 + warp * 16 + gq;
  // tiles that need no mask: all keys valid for every row of the block
  auto is_full = [&](int kt0) {
    return kt0 + BK <= kend && (!causal || kt0 + BK - 1 <= qoff + q0) &&
           (!has_window || kt0 > qoff + q0 + GQ - 1 - window);
  };
  // S = Q K^T of stage st: DP / 16 k-steps of 16 columns, 32 bytes within
  // a panel row
  auto issue_s = [&](float* s, int st) {
    const unsigned char* cK = sK + st * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<BK>(s,
               wg_desc(sQ + (kk >> 2) * GQ * 128 + (kk & 3) * 32, 16, 1024),
               wg_desc(cK + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024),
               kk > 0);
  };
  // O += P V of stage st: P from registers, V as the MN-major B operand,
  // one panel of 64 output columns a product
  auto issue_pv = [&](float (*acc)[32], uint32_t (*pa)[4], int st) {
    const unsigned char* cV = sV + st * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs(acc[p], pa[kk],
                 wg_desc(cV + p * BK * 128 + kk * 2048, BK * 128, 1024));
  };

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[NV], alpha[2] = {1.f, 1.f};
  uint32_t pa[BK / 16][4];

  for (int t = 0; t < nt; ++t) {
    const int st = t % ST;
    const int kt0 = kbeg + t * BK;
    if (t == 0) mbar_wait(&qbar, 0);
    mbar_wait(&full[st], (t / ST) & 1);
#pragma unroll
    for (int i = 0; i < NV; ++i) s[i] = 0.f;
    wg_fence();
    issue_s(s, st);
    wg_commit();
    wg_wait0();
    wg_touch<NV>(s);
    softmax_tile<NV>(s, pa, m, l, alpha, kt0, is_full(kt0), kend, qrow, tq,
                     causal, has_window, window, has_softcap, softcap,
                     scale);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row's max moved
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            acc[p][4 * j + 2 * r] *= alpha[r];
            acc[p][4 * j + 2 * r + 1] *= alpha[r];
          }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) wg_touch(acc[p]);
    wg_fence();
    issue_pv(acc, pa, st);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < NP; ++p) wg_touch(acc[p]);
    mbar_arrive(&empty[st]);  // this thread is done with stage st
  }
  // the warpgroup's last products have read Q
  asm volatile("bar.sync 1, %0;\n" ::"n"(GNT) : "memory");

  // normalise, stage the warp's 16 rows in its own rows of the Q tile (same
  // swizzled layout; Q is no longer read), store 16 bytes a thread
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float ls = l[r];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    inv[r] = ls > 0.f ? 1.f / ls : 0.f;
    // the row's log-sum-exp of the scaled (and capped) scores, for the
    // backward; m is the same in the quad, kept unscaled without a softcap
    const int qi = q0 + warp * 16 + gq + 8 * r;
    if (lse && tq == 0 && qi < Sq)
      lse[((long long)b * Hq + h) * Sq + qi] =
          ls > 0.f ? m[r] * (has_softcap ? 1.f : scale) + logf(ls)
                   : -INFINITY;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + gq + 8 * r;
        *reinterpret_cast<uint32_t*>(sQ + p * GQ * 128 + row * 128 +
                                     ((j ^ (row & 7)) << 4) + tq * 4) =
            pack_bf16(acc[p][4 * j + 2 * r] * inv[r],
                      acc[p][4 * j + 2 * r + 1] * inv[r]);
      }
  __syncwarp();
  constexpr int CH = DP / 8;
  const long long qs = (long long)Hq * D;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = warp * 16 + i / CH;
    const int c = i % CH;
    const int qi = q0 + r;
    if (qi < Sq && c * 8 < D)
      *reinterpret_cast<uint4*>(o + ((long long)b * Sq + qi) * qs +
                                (long long)h * D + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + (c >> 3) * GQ * 128 +
                                          r * 128 +
                                          (((c & 7) ^ (r & 7)) << 4));
  }
}

// ------------------------------------------------- f32 prefill, FMA pipes

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)

// Stage `rows` rows from row0 on of one head of a (B, S, H, D) f32 tensor
// into shared memory times `mul`, row stride LD.  Rows at or past
// `nvalid` and columns at or past D are zero.
template <int DP, int LD, int THREADS>
__device__ inline void load_tile(float* s, const float* base, int rows,
                                 int row0, int nvalid, long long row_stride,
                                 int D, float mul) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < nvalid && c < D)
      load16(base + (long long)(row0 + r) * row_stride + c, vals);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r * LD + c + j] = vals[j] * mul;
  }
}

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ inline float comp(float4 a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

template <int DP>
constexpr size_t flash_f32_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (DP + 4) +
                          (size_t)BQ * (BK + 4));
}

template <int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              const int* __restrict__ kv_len, int kv_len_all,
              const int* __restrict__ q_off, int q_off_all, int Sq, int Skv,
              int Hq, int Hkv, int D, int causal, int has_window, int window,
              int has_softcap, float softcap, float scale,
              float* __restrict__ lse) {
  constexpr int LD = DP + 4;
  constexpr int LDP = BK + 4;
  constexpr int CG = DP / 64;           // float4 output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const int qoff = q_off ? q_off[b] : q_off_all;
  int kend = min(kv_len ? kv_len[b] : kv_len_all, Skv);
  if (causal) kend = min(kend, qoff + min(q0 + BQ, Sq));
  int kbeg = 0;
  if (has_window) kbeg = max(0, qoff + q0 - window + 1) / BK * BK;

  const long long qs = (long long)Hq * D;
  const long long ks = (long long)Hkv * D;
  const float* kb = k + (long long)b * Skv * ks + (long long)hk * D;
  const float* vb = v + (long long)b * Skv * ks + (long long)hk * D;
  load_tile<DP, LD, NT>(sQ, q + (long long)b * Sq * qs + (long long)h * D,
                        BQ, q0, Sq - q0, qs, D, scale);

  float m[4], l[4], acc[4][CG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kt0 = kbeg; kt0 < kend; kt0 += BK) {
    __syncthreads();
    load_tile<DP, LD, NT>(sK, kb, BK, kt0, kend - kt0, ks, D, 1.f);
    load_tile<DP, LD, NT>(sV, vb, BK, kt0, kend - kt0, ks, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qoff + q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kt0 + tx + 16 * j;
        float x = s[i][j];
        if (has_softcap) x = tanhf(x / softcap) * softcap;
        bool ok = kp < kend;
        if (causal) ok = ok && kp <= qp;
        if (has_window) ok = ok && kp > qp - window;
        s[i][j] = ok ? x : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mnew = fmaxf(m[i], rmax);
      float alpha = 1.f, rsum = 0.f;
      if (mnew != -INFINITY) {
        alpha = expf(m[i] - mnew);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mnew);
          rsum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < CG * 4; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sV[(kk + u) * LD + cg * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pv[i], u);
            acc[i][cg * 4 + 0] = fmaf(p, vv.x, acc[i][cg * 4 + 0]);
            acc[i][cg * 4 + 1] = fmaf(p, vv.y, acc[i][cg * 4 + 1]);
            acc[i][cg * 4 + 2] = fmaf(p, vv.z, acc[i][cg * 4 + 2]);
            acc[i][cg * 4 + 3] = fmaf(p, vv.w, acc[i][cg * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    // m and l are the same in the row's 16 threads; the scores are scaled
    if (lse && tx == 0)
      lse[((long long)b * Hq + h) * Sq + qi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    float* orow = o + ((long long)b * Sq + qi) * qs + (long long)h * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const int c = cg * 64 + tx * 4;
      if (c < D)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i][cg * 4] * inv, acc[i][cg * 4 + 1] * inv,
                        acc[i][cg * 4 + 2] * inv, acc[i][cg * 4 + 3] * inv);
    }
  }
}

// ---------------------------------------------------- split-KV decode

constexpr int DK = 32;    // decode: keys per tile, one per lane
constexpr int DNS = 2;    // decode: K/V stages
constexpr int DNT = 128;  // decode: threads per block, 4 warps
constexpr int DHW = 4;    // decode: query heads per warp, so g <= 16
constexpr int CNT = 512;  // combine: threads per block

template <typename T>
size_t decode_smem_bytes(int g, int D) {
  const size_t LD = D + 16 / sizeof(T);
  return 2 * DNS * DK * LD * sizeof(T) + sizeof(float) * (size_t)g * D;
}

// q (B, 1, Hq, D); k, v (B, Skv, Hkv, D).  Block (split, hk, b) covers the
// keys [split * chunk, split * chunk + chunk); warp w takes the query heads
// w, w + 4, ... of the KV head's g.  Scratch rows are (B, Hkv, n_split, g):
// acc (rows x D), then m (rows), then l (rows).
template <typename T>
__global__ void __launch_bounds__(DNT)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, float* __restrict__ scratch,
               const int* __restrict__ kv_len, int kv_len_all,
               const int* __restrict__ q_off, int q_off_all, int Skv, int Hq,
               int Hkv, int D, int chunk, int causal, int has_window,
               int window, int has_softcap, float softcap, float scale) {
  // the combine may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  const int LD = D + V;
  const int CH = D / V;               // 16-byte chunks per row
  const int g = Hq / Hkv;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rows = (long long)gridDim.z * Hkv * gridDim.x * g;
  const long long row0 = (((long long)b * Hkv + hk) * gridDim.x + split) * g;
  float* part_m = scratch + rows * D;
  float* part_l = part_m + rows;

  // the valid keys of this split: one interval, the same for all g heads
  const int qp = q_off ? q_off[b] : q_off_all;
  int hi = min(kv_len ? kv_len[b] : kv_len_all, Skv);
  if (causal) hi = min(hi, qp + 1);
  int lo = has_window ? max(0, qp - window + 1) : 0;
  lo = max(lo, split * chunk);
  hi = min(hi, split * chunk + chunk);
  if (lo >= hi) {
    for (int r = threadIdx.x; r < g; r += DNT) {
      part_m[row0 + r] = -INFINITY;
      part_l[row0 + r] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char dsmem[];
  T* sK = reinterpret_cast<T*>(dsmem);  // [DNS][DK][LD]
  T* sV = sK + DNS * DK * LD;           // [DNS][DK][LD]
  float* sQ = reinterpret_cast<float*>(sV + DNS * DK * LD);  // g x D, scaled

  const long long ks = (long long)Hkv * D;
  const T* kb = k + (long long)b * Skv * ks + (long long)hk * D;
  const T* vb = v + (long long)b * Skv * ks + (long long)hk * D;
  // Tiles start at multiples of DK (so does the chunk): rows of a tile
  // before lo are cache rows the scores mask, rows at or past hi are zeros.
  // A ring of DNS stages: tile t goes to stage t % DNS, one copy group per
  // tile (empty past the last), DNS - 1 tiles ahead of the one in use.
  const int t_first = lo / DK * DK;
  const int nt = (hi - t_first + DK - 1) / DK;
  auto issue = [&](int t) {
    if (t < nt) {
      const int r0 = t_first + t * DK;
      copy_tile<T, DNT>(sK + (t % DNS) * DK * LD, kb, DK, D, LD, r0,
                        hi - r0, ks, D);
      copy_tile<T, DNT>(sV + (t % DNS) * DK * LD, vb, DK, D, LD, r0,
                        hi - r0, ks, D);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < DNS - 1; ++t) issue(t);
  // the g query heads of this KV head are consecutive rows of length D
  const T* qh = q + ((long long)b * Hq + (long long)hk * g) * D;
  for (int i = threadIdx.x; i < g * CH; i += DNT) {
    float x[V];
    load16(qh + i * V, x);
#pragma unroll
    for (int u = 0; u < V; ++u) sQ[i * V + u] = x[u] * scale;
  }

  // P V lanes: CW lanes cover one row (CW a power of two >= CH, at most
  // 32), KQ = 32 / CW rows at a time; lane chunk c = lane % CW (+ 32)
  const int CW = CH > 16 ? 32 : CH > 8 ? 16 : CH > 4 ? 8 : CH > 2 ? 4 : 2;
  const int KQ = 32 / CW;
  const int c0 = lane % CW;
  float m[DHW], l[DHW], acc[DHW][8];  // acc: chunks c0 and c0 + 32
#pragma unroll
  for (int i = 0; i < DHW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
  }

  for (int t = 0; t < nt; ++t) {
    const int t0 = t_first + t * DK;
    issue(t + DNS - 1);  // its stage was last read at t - 1
    cp_async_wait<DNS - 1>();
    __syncthreads();
    const T* cK = sK + (t % DNS) * DK * LD;
    const T* cV = sV + (t % DNS) * DK * LD;
    const bool live = t0 + lane >= lo && t0 + lane < hi;

#pragma unroll
    for (int i = 0; i < DHW; ++i) {
      const int h = warp + 4 * i;
      if (h >= g) break;
      // the score of key t0 + lane, in four chains
      const T* kr = cK + lane * LD;
      const float* qr = sQ + h * D;
      float xs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int c = 0; c < D; c += V) {
        float kv[V];
        load16(kr + c, kv);
#pragma unroll
        for (int u = 0; u < V; u += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + c + u);
          xs[0] = fmaf(qv.x, kv[u], xs[0]);
          xs[1] = fmaf(qv.y, kv[u + 1], xs[1]);
          xs[2] = fmaf(qv.z, kv[u + 2], xs[2]);
          xs[3] = fmaf(qv.w, kv[u + 3], xs[3]);
        }
      }
      float x = (xs[0] + xs[1]) + (xs[2] + xs[3]);
      if (has_softcap) x = tanhf(x / softcap) * softcap;
      if (!live) x = -INFINITY;

      // online softmax across the warp (every tile has a live key)
      const float mnew = fmaxf(m[i], warp_max(x));
      const float alpha = mnew == -INFINITY ? 1.f : expf(m[i] - mnew);
      const float p = x == -INFINITY ? 0.f : expf(x - mnew);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = mnew;
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] *= alpha;

      // acc += p V: rows jj + lane / CW, the weight from the row's lane
      for (int jj = 0; jj < DK; jj += KQ) {
        const int jr = jj + lane / CW;
        const float pj = __shfl_sync(0xffffffffu, p, jr);
#pragma unroll
        for (int n = 0; n < 8 / V; ++n) {
          const int c = c0 + 32 * n;
          if (c < CH) {
            float vv[V];
            load16(cV + jr * LD + c * V, vv);
#pragma unroll
            for (int u = 0; u < V; ++u)
              acc[i][n * V + u] = fmaf(pj, vv[u], acc[i][n * V + u]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled at t + 1
  }

  // sum the KQ row groups; lanes below CW hold their chunks' totals
#pragma unroll
  for (int i = 0; i < DHW; ++i) {
    const int h = warp + 4 * i;
    if (h >= g) break;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      for (int off = CW; off < 32; off <<= 1)
        acc[i][u] += __shfl_xor_sync(0xffffffffu, acc[i][u], off);
    float* out = scratch + (row0 + h) * D;
#pragma unroll
    for (int n = 0; n < 8 / V; ++n) {
      const int c = c0 + 32 * n;
      if (lane < CW && c < CH)
#pragma unroll
        for (int u = 0; u < V; ++u) out[c * V + u] = acc[i][n * V + u];
    }
    if (lane == 0) {
      part_m[row0 + h] = m[i];
      part_l[row0 + h] = l[i];
    }
  }
}

// Merge the splits of one (KV head, batch) in split order; o (B, 1, Hq, D).
// First one warp per head finds the splits' weights exp(m_s - M) / L in
// shared memory (n_split x g floats), and writes M + log L to lse (B, Hq)
// f32 where lse is given; then each thread sums its outputs over the
// splits.
template <typename T>
__global__ void __launch_bounds__(CNT)
decode_combine(const float* __restrict__ scratch, T* __restrict__ o,
               float* __restrict__ lse, int n_split, int Hq, int Hkv,
               int D) {
  // launched early (programmatic dependent launch): wait until the
  // partials are written
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ float sW[];  // [n_split][g]
  const int g = Hq / Hkv;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)gridDim.y * Hkv * n_split * g;
  const float* part_m = scratch + rows * D;
  const float* part_l = part_m + rows;
  const long long row0 = ((long long)b * Hkv + hk) * n_split * g;
  for (int h = threadIdx.x >> 5; h < g; h += CNT / 32) {
    float M = -INFINITY;
    for (int s = lane; s < n_split; s += 32)
      M = fmaxf(M, part_m[row0 + (long long)s * g + h]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const long long r = row0 + (long long)s * g + h;
      // an empty split (m = -inf) weighs 0; its acc, never written, is
      // selected away below
      const float w = part_m[r] == -INFINITY ? 0.f : expf(part_m[r] - M);
      sW[s * g + h] = w;
      L += part_l[r] * w;
    }
    L = warp_sum(L);
    const float inv = L > 0.f ? 1.f / L : 0.f;
    // the row's log-sum-exp, -inf where no split had a valid key
    if (lse != nullptr && lane == 0)
      lse[(long long)b * Hq + (long long)hk * g + h] =
          L > 0.f ? M + logf(L) : -INFINITY;
    __syncwarp();
    for (int s = lane; s < n_split; s += 32) sW[s * g + h] *= inv;
  }
  __syncthreads();
  const float* acc = scratch + row0 * D;
  for (int i = threadIdx.x; i < g * D; i += CNT) {
    const int h = i / D;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float w = sW[s * g + h];
      const float x = acc[(long long)s * g * D + i];  // garbage where w = 0
      a = fmaf(w != 0.f ? x : 0.f, w, a);
    }
    store1(o + ((long long)b * Hq + (long long)hk * g) * D + i, a);
  }
}

// ------------------------------------------- backward, f32 FMA pipes

constexpr int BNT = 256;  // backward: threads per block (16 x 16)

// Tiles of the backward: R query rows and R key rows (32 at DP = 256, so
// that four R x DP f32 tiles and the two R x R score tiles fit in shared
// memory); a thread holds RI x RI scores, rows ty + 16 i and columns
// tx + 16 j, and of a tile's R x DP outputs the rows ty + 16 i and the
// columns cg * 64 + tx * 4 + u (CG float4 groups).
template <int DP>
struct BwdCfg {
  static constexpr int R = DP > 128 ? 32 : 64;
  static constexpr int RI = R / 16;
  static constexpr int LD = DP + 4;
  static constexpr int LDP = R + 4;
  static constexpr int CG = DP / 64;
  static constexpr size_t smem =
      sizeof(float) * (4 * (size_t)R * LD + 2 * (size_t)R * LDP + 2 * R);
};

// acc[i][j] = a row (ty + 16 i) . b row (tx + 16 j), over DP columns
template <int DP, int LD, int RI>
__device__ inline void dots(float (*acc)[RI], const float* a,
                            const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 av[RI], bv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < RI; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) acc[i][j] = dot4(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][cg * 4 + u] += sum over the tile's R rows kk of
// w[(ty + 16 i) * LDP + kk] * m[kk * LD + cg * 64 + tx * 4 + u]
template <int R, int LD, int LDP, int RI, int CG>
__device__ inline void accumulate(float (*acc)[CG * 4], const float* w,
                                  const float* m, int ty, int tx) {
#pragma unroll 2
  for (int kk = 0; kk < R; kk += 4) {
    float4 wv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      wv[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * LDP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int cg = 0; cg < CG; ++cg) {
        const float4 mv = *reinterpret_cast<const float4*>(
            m + (kk + u) * LD + cg * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float p = comp(wv[i], u);
          acc[i][cg * 4 + 0] = fmaf(p, mv.x, acc[i][cg * 4 + 0]);
          acc[i][cg * 4 + 1] = fmaf(p, mv.y, acc[i][cg * 4 + 1]);
          acc[i][cg * 4 + 2] = fmaf(p, mv.z, acc[i][cg * 4 + 2]);
          acc[i][cg * 4 + 3] = fmaf(p, mv.w, acc[i][cg * 4 + 3]);
        }
      }
  }
}

// One score of the backward: from the raw dot s = q . k and dp = dO . v,
// with the row's log-sum-exp in log2 units (lse2 = lse log2(e)) and delta,
// the probability p and the score gradient ds, already times d(capped
// scaled score) / ds, so that dQ = ds K and dK = ds^T Q.  p = ds = 0 where
// the masks drop the pair.  Without a softcap the exponent is one FMA.
__device__ __forceinline__ void score_grad(float s, float dp, float lse2,
                                           float delta, bool ok,
                                           int has_softcap, float softcap,
                                           float scale, float* p, float* ds) {
  float x2, dx = scale;  // the capped scaled score, in log2 units
  if (has_softcap) {
    const float t = tanhf(s * scale / softcap);
    x2 = t * softcap * kLog2e;
    dx = scale * (1.f - t * t);
  } else {
    x2 = s * (scale * kLog2e);
  }
  *p = ok && lse2 != -INFINITY ? exp2f(x2 - lse2) : 0.f;
  *ds = *p * (dp - delta) * dx;
}

// delta[(b Hq + h) SqP + i] = sum_d dO[b, i, h, d] O[b, i, h, d] in f32, a
// warp a row; rows i in [Sq, SqP) get 0.  With lse_pad, the forward's
// log-sum-exp lse[b, h, i] times log2(e) goes beside it in the same padded
// layout (0 past Sq), so that the wgmma kernels load whole 64-row tiles of
// both.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ delta,
                float* __restrict__ lse_pad, long long rows, int Sq, int SqP,
                int Hq, int D) {
  constexpr int V = 16 / sizeof(T);
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const long long bh = r / SqP;
  const int qi = (int)(r % SqP);
  float acc = 0.f;
  if (qi < Sq) {
    const long long at = ((bh / Hq * Sq + qi) * Hq + bh % Hq) * D;
    for (int c = lane * V; c < D; c += 32 * V) {
      float a[V], g[V];
      load16(o + at + c, a);
      load16(dout + at + c, g);
#pragma unroll
      for (int u = 0; u < V; ++u) acc = fmaf(a[u], g[u], acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    delta[r] = acc;
    if (lse_pad) lse_pad[r] = qi < Sq ? lse[bh * Sq + qi] * kLog2e : 0.f;
  }
}

// dQ: block (q tile, query head, batch) over the KV tiles its rows see;
// dQ += dS K.  The q tile is the slowest axis, longest causal rows first.
template <int DP>
__global__ void __launch_bounds__(BNT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
             int causal, int has_window, int window, int has_softcap,
             float softcap, float scale) {
  using C = BwdCfg<DP>;
  constexpr int R = C::R, RI = C::RI, LD = C::LD, LDP = C::LDP, CG = C::CG;
  extern __shared__ __align__(16) float bsm[];
  float* sQ = bsm;           // R x LD
  float* sO = sQ + R * LD;   // dO, R x LD
  float* sK = sO + R * LD;   // R x LD
  float* sV = sK + R * LD;   // R x LD
  float* sS = sV + R * LD;   // dS, R x LDP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long qs = (long long)Hq * D;
  const long long ks = (long long)Hkv * D;
  int kend = Skv;
  if (causal) kend = min(kend, min(q0 + R, Sq));
  const int kbeg = has_window ? max(0, q0 - window + 1) / R * R : 0;

  load_tile<DP, LD, BNT>(sQ, q + (long long)b * Sq * qs + (long long)h * D,
                         R, q0, Sq - q0, qs, D, 1.f);
  load_tile<DP, LD, BNT>(sO, dout + (long long)b * Sq * qs + (long long)h * D,
                         R, q0, Sq - q0, qs, D, 1.f);
  float lq[RI], dl[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    const long long at = ((long long)b * Hq + h) * Sq + qi;
    lq[i] = qi < Sq ? lse[at] * kLog2e : -INFINITY;
    dl[i] = qi < Sq ? delta[at] : 0.f;
  }
  float acc[RI][CG * 4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) acc[i][c] = 0.f;

  const float* kb = k + (long long)b * Skv * ks + (long long)hk * D;
  const float* vb = v + (long long)b * Skv * ks + (long long)hk * D;
  for (int kt0 = kbeg; kt0 < kend; kt0 += R) {
    __syncthreads();  // the last tile's sK and sS are read
    load_tile<DP, LD, BNT>(sK, kb, R, kt0, kend - kt0, ks, D, 1.f);
    load_tile<DP, LD, BNT>(sV, vb, R, kt0, kend - kt0, ks, D, 1.f);
    __syncthreads();
    float s[RI][RI], dp[RI][RI];
    dots<DP, LD, RI>(s, sQ, sK, ty, tx);
    dots<DP, LD, RI>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int qp = q0 + ty + 16 * i;
        const int kp = kt0 + tx + 16 * j;
        bool ok = kp < kend && qp < Sq;
        if (causal) ok = ok && kp <= qp;
        if (has_window) ok = ok && kp > qp - window;
        float p, ds;
        score_grad(s[i][j], dp[i][j], lq[i], dl[i], ok, has_softcap,
                   softcap, scale, &p, &ds);
        sS[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
      }
    __syncthreads();
    accumulate<R, LD, LDP, RI, CG>(acc, sS, sK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    float* row = dq + ((long long)b * Sq + qi) * qs + (long long)h * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const int c = cg * 64 + tx * 4;
      if (c < D)
#pragma unroll
        for (int u = 0; u < 4; ++u) store1(row + c + u, acc[i][cg * 4 + u]);
    }
  }
}

// dK, dV: block (KV tile, KV head, batch) over the g query heads of its
// KV head and the q tiles whose rows see its keys; dV += P^T dO and
// dK += dS^T Q, summed over the group's heads.  Scores are held
// transposed: rows are keys, columns queries.
template <int DP>
__global__ void __launch_bounds__(BNT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv, int D,
               int causal, int has_window, int window, int has_softcap,
               float softcap, float scale) {
  using C = BwdCfg<DP>;
  constexpr int R = C::R, RI = C::RI, LD = C::LD, LDP = C::LDP, CG = C::CG;
  extern __shared__ __align__(16) float bsm[];
  float* sK = bsm;           // this block's keys, R x LD
  float* sV = sK + R * LD;   // R x LD
  float* sQ = sV + R * LD;   // a q tile, R x LD
  float* sO = sQ + R * LD;   // its dO, R x LD
  float* sP = sO + R * LD;   // P^T, R x LDP
  float* sS = sP + R * LDP;  // dS^T, R x LDP
  float* sL = sS + R * LDP;  // the q tile's lse, R
  float* sD = sL + R;        // its delta, R

  const int k0 = blockIdx.x * R;  // the first KV tiles see the most rows
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = Hq / Hkv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long qs = (long long)Hq * D;
  const long long ks = (long long)Hkv * D;
  const int qbeg = causal ? k0 / R * R : 0;
  int qend = Sq;
  if (has_window) qend = min(qend, k0 + R - 1 + window);

  load_tile<DP, LD, BNT>(sK, k + (long long)b * Skv * ks + (long long)hk * D,
                         R, k0, Skv - k0, ks, D, 1.f);
  load_tile<DP, LD, BNT>(sV, v + (long long)b * Skv * ks + (long long)hk * D,
                         R, k0, Skv - k0, ks, D, 1.f);
  float dka[RI][CG * 4], dva[RI][CG * 4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int h = hk * g; h < hk * g + g; ++h) {
    const float* qb = q + (long long)b * Sq * qs + (long long)h * D;
    const float* ob = dout + (long long)b * Sq * qs + (long long)h * D;
    const long long row0 = ((long long)b * Hq + h) * Sq;
    for (int qt0 = qbeg; qt0 < qend; qt0 += R) {
      __syncthreads();  // the last tile's sQ, sO, sP, sS are read
      load_tile<DP, LD, BNT>(sQ, qb, R, qt0, Sq - qt0, qs, D, 1.f);
      load_tile<DP, LD, BNT>(sO, ob, R, qt0, Sq - qt0, qs, D, 1.f);
      for (int t = threadIdx.x; t < R; t += BNT) {
        const int qi = qt0 + t;
        sL[t] = qi < Sq ? lse[row0 + qi] * kLog2e : -INFINITY;
        sD[t] = qi < Sq ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();
      float s[RI][RI], dp[RI][RI];
      dots<DP, LD, RI>(s, sK, sQ, ty, tx);
      dots<DP, LD, RI>(dp, sV, sO, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int kp = k0 + ty + 16 * i;
          const int qp = qt0 + tx + 16 * j;
          bool ok = kp < Skv && qp < Sq;
          if (causal) ok = ok && kp <= qp;
          if (has_window) ok = ok && kp > qp - window;
          float p, ds;
          score_grad(s[i][j], dp[i][j], sL[tx + 16 * j], sD[tx + 16 * j],
                     ok, has_softcap, softcap, scale, &p, &ds);
          sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
          sS[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
        }
      __syncthreads();
      accumulate<R, LD, LDP, RI, CG>(dva, sP, sO, ty, tx);
      accumulate<R, LD, LDP, RI, CG>(dka, sS, sQ, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= Skv) continue;
    const long long at = ((long long)b * Skv + ki) * ks + (long long)hk * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const int c = cg * 64 + tx * 4;
      if (c < D)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          store1(dk + at + c + u, dka[i][cg * 4 + u]);
          store1(dv + at + c + u, dva[i][cg * 4 + u]);
        }
    }
  }
}

// ------------------------------------- backward, bf16: wgmma + TMA

// Tiles of the bf16 backward on the tensor cores: three passes, each a block
// of one consumer warpgroup owning BM = 64 rows (keys for dV and dK,
// queries for dQ) and a producer warp whose lane 0 streams the other side
// through a ring of ST stages in tiles of BN = 64 rows, BLOCKS blocks an
// SM (two at DP <= 128, one at DP 256: see the file's header).  Every tile
// is DP / 64 panels of 64 rows x 128 bytes in the 128-byte swizzle, as in
// flash_fwd_bf16, loaded by TMA with D zero-padded to DP.  The passes hold
// one f32 accumulator each: dK and dV in one warpgroup would need ~240
// registers a thread at DP 128, one block an SM, and the elementwise work
// between the products then has no other warps to hide behind.
template <int DP>
struct BwdWgCfg {
  static constexpr int BM = 64;
  static constexpr int BN = 64;
  static constexpr int ST = 2;
  static constexpr int BLOCKS = DP > 128 ? 1 : 2;
  static constexpr int NP = DP / 64;
  static constexpr int THREADS = GNT + 32;
  static constexpr int TILE = 64 * DP * 2;  // bytes of a 64-row tile
  static constexpr int ROWS = 2 * BN * 4;   // a stage's lse and delta
  // dV: K stays; dK: K and V; dQ: Q and dO.  Q, dO, lse, delta or K, V
  // stream.
  static constexpr size_t smem_dv = 1024 + TILE + ST * (2 * TILE + ROWS);
  static constexpr size_t smem_dk = 1024 + 2 * TILE + ST * (2 * TILE + ROWS);
  static constexpr size_t smem_dq = 1024 + 2 * TILE + ST * 2 * TILE;
};
// rows of the padded lse / delta layout, a multiple of a block's rows
constexpr int kLsePad = 128;

// Round a warpgroup's 64 x DP f32 accumulator to bf16 into its 64-row tile
// (the swizzled layout it was loaded in), then store the warp's 16 rows,
// 16 bytes a thread, for tile rows below nrows and columns below D.
template <int DP>
__device__ inline void store_tile(unsigned char* tile, float (*acc)[32],
                                  __nv_bfloat16* __restrict__ out, int nrows,
                                  long long row_stride, int D, int warp,
                                  int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int p = 0; p < DP / 64; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + gq + 8 * r;
        *reinterpret_cast<uint32_t*>(tile + p * 64 * 128 + row * 128 +
                                     ((j ^ (row & 7)) << 4) + tq * 4) =
            pack_bf16(acc[p][4 * j + 2 * r], acc[p][4 * j + 2 * r + 1]);
      }
  __syncwarp();
  constexpr int CH = DP / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = warp * 16 + i / CH;
    const int c = i % CH;
    if (r < nrows && c * 8 < D)
      *reinterpret_cast<uint4*>(out + (long long)r * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + (c >> 3) * 64 * 128 +
                                          r * 128 +
                                          (((c & 7) ^ (r & 7)) << 4));
  }
}

// One 64 x BN tile of scores of the warpgroup (NV = BN / 2 in this thread:
// element i at tile row warp * 16 + gq + 8 ((i >> 1) & 1) and column
// (i >> 2) * 8 + 2 tq + (i & 1)): from the raw products s and dp, P (WANT_P)
// or dS in f32 by score_grad's math, rounded to bf16 straight into the A
// fragments of the product that follows (fa), and with SPLIT what that
// rounding left out, rounded again (fl), so that fa + fl carry ~16 bits.
// KV_ROWS: the rows are keys (lse2 and delta by column) or queries (by
// row).  The softcap (CAP) and a tile all of whose pairs are valid (WHOLE)
// are compile-time cases, so that the 32 scores run without branches: the
// registers left beside the accumulators hold little else.  A pair the
// masks keep always has a finite lse2, so the -inf test of score_grad is
// not needed here.
template <int NV, bool KV_ROWS, bool WANT_P, bool SPLIT, bool CAP, bool WHOLE>
__device__ __forceinline__ void grad_tile(
    const float* s, const float* dp, uint32_t (*fa)[4], uint32_t (*fl)[4],
    const float* lse2, const float* delta, int row0, int col0, int Sq,
    int Skv, int tq, int causal, int has_window, int window, float softcap,
    float scale) {
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < NV; i += 2) {
    float x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = (i >> 2) * 8 + 2 * tq + e;
      const int at = KV_ROWS ? c : (i >> 1) & 1;
      float x2, dx = scale;
      if constexpr (CAP) {
        const float t = tanhf(s[i + e] * scale / softcap);
        x2 = t * softcap * kLog2e;
        dx = scale * (1.f - t * t);
      } else {
        x2 = s[i + e] * sl2;
      }
      float p = exp2f(x2 - lse2[at]);
      if constexpr (!WHOLE) {
        const int row = row0 + ((i >> 1) & 1) * 8;
        const int kp = KV_ROWS ? row : col0 + c;
        const int qp = KV_ROWS ? col0 + c : row;
        bool ok = kp < Skv && qp < Sq;
        if (causal) ok = ok && kp <= qp;
        if (has_window) ok = ok && kp > qp - window;
        p = ok ? p : 0.f;
      }
      if constexpr (WANT_P)
        x[e] = p;
      else
        x[e] = p * (dp[i + e] - delta[at]) * dx;
    }
    const int f = i >> 3, r = (i >> 1) & 3;
    fa[f][r] = pack_bf16(x[0], x[1]);
    if constexpr (SPLIT) fl[f][r] = pack_lo(x[0], x[1], fa[f][r]);
  }
}

// grad_tile with the softcap and whole-tile cases chosen at run time
template <int NV, bool KV_ROWS, bool WANT_P, bool SPLIT>
__device__ __forceinline__ void grad_tile_any(
    bool cap, bool whole, const float* s, const float* dp,
    uint32_t (*fa)[4], uint32_t (*fl)[4], const float* lse2,
    const float* delta, int row0, int col0, int Sq, int Skv, int tq,
    int causal, int has_window, int window, float softcap, float scale) {
#define GRAD_ARGS                                                          \
  s, dp, fa, fl, lse2, delta, row0, col0, Sq, Skv, tq, causal, has_window, \
      window, softcap, scale
  if (cap) {
    if (whole)
      grad_tile<NV, KV_ROWS, WANT_P, SPLIT, true, true>(GRAD_ARGS);
    else
      grad_tile<NV, KV_ROWS, WANT_P, SPLIT, true, false>(GRAD_ARGS);
  } else {
    if (whole)
      grad_tile<NV, KV_ROWS, WANT_P, SPLIT, false, true>(GRAD_ARGS);
    else
      grad_tile<NV, KV_ROWS, WANT_P, SPLIT, false, false>(GRAD_ARGS);
  }
#undef GRAD_ARGS
}

// d (64 x BN f32) = A (64 x DP, the warpgroup's tile) B^T (B: a BN x DP
// tile), both K-major in shared memory: DP / 16 products of 16 columns.
template <int DP, int BN>
__device__ inline void issue_nt(float* d, const unsigned char* a,
                                const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<BN>(d, wg_desc(a + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16,
                            1024),
                 wg_desc(b + (kk >> 2) * BN * 128 + (kk & 3) * 32, 16, 1024),
                 kk > 0);
}

// acc (64 x DP f32) += A (64 x BN, bf16 fragments in registers) B (a BN x
// DP tile, read as the MN-major operand), one 64-column panel a product
template <int DP, int BN>
__device__ inline void issue_nn(float (*acc)[32], uint32_t (*a)[4],
                                const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
      wgmma_rs(acc[p], a[kk],
               wg_desc(b + p * BN * 128 + kk * 2048, BN * 128, 1024));
}

__device__ inline void init_ring(uint64_t* full, uint64_t* empty,
                                 uint64_t* own, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GNT);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// dV (DV) or dK: block (KV head, batch, tile of 64 keys; the slowest axis,
// so the first key tiles, which see the most query rows, go first).  K
// (and V for dK) is loaded once; the q tiles of the group's g heads whose
// rows see the keys stream through the ring with their lse2 (and delta).
// Per tile: S^T = K Q^T (and dP^T = V dO^T; wgmma, both operands in shared
// memory), P^T (dS^T) in registers, then dV += P^T dO (dK += dS^T Q; wgmma,
// A from registers, dO / Q as the MN-major B).  P^T and dS^T go in as a
// bf16 pair hi + lo, two products, so that the sums over g x Sq rows keep
// ~16 bits of each.  The accumulator stays in f32 registers over all the
// group's heads and is rounded once.
template <int DP, bool DV>
__global__ void __launch_bounds__(BwdWgCfg<DP>::THREADS,
                                  BwdWgCfg<DP>::BLOCKS)
flash_bwd_kv_wg(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do,
                const float* __restrict__ lse_p,
                const float* __restrict__ delta_p,
                __nv_bfloat16* __restrict__ out, int Sq, int SqP, int Skv,
                int Hq, int Hkv, int D, int causal, int has_window,
                int window, int has_softcap, float softcap, float scale) {
  using C = BwdWgCfg<DP>;
  constexpr int NP = C::NP, ST = C::ST, BM = C::BM, BN = C::BN;
  constexpr int NV = BN / 2;
  constexpr int OWN = DV ? 1 : 2;  // resident tiles: K, or K and V
  extern __shared__ __align__(16) unsigned char wsm[];
  __shared__ uint64_t full[ST], empty[ST], kvbar;
  unsigned char* base = wsm + ((1024 - (smem_u32(wsm) & 1023)) & 1023);
  unsigned char* sK = base;                   // [TILE]
  unsigned char* sV = sK + C::TILE;           // [TILE], dK only
  unsigned char* sQ = sK + OWN * C::TILE;     // [ST][TILE]
  unsigned char* sO = sQ + ST * C::TILE;      // dO, [ST][TILE]
  float* sL = reinterpret_cast<float*>(sO + ST * C::TILE);  // [ST][2][BN]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BM;
  const int g = Hq / Hkv;
  const int qbeg = causal ? k0 / BN * BN : 0;
  int qend = Sq;
  if (has_window) qend = min(qend, k0 + BM - 1 + window);
  const int nq = qend > qbeg ? (qend - qbeg + BN - 1) / BN : 0;
  const int nt = g * nq;  // (head, q tile) pairs, head-major
  init_ring(full, empty, &kvbar, ST);

  if (threadIdx.x >= GNT) {  // the producer warp
    if (threadIdx.x == GNT && nt > 0) {
      mbar_expect(&kvbar, OWN * C::TILE);
      for (int p = 0; p < NP; ++p) {
        tma_panel(sK + p * BM * 128, &map_k, &kvbar, 64 * p, hk, k0, b);
        if (!DV)
          tma_panel(sV + p * BM * 128, &map_v, &kvbar, 64 * p, hk, k0, b);
      }
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST;
        const int h = hk * g + t / nq;
        const int qt0 = qbeg + (t % nq) * BN;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        mbar_expect(&full[s], 2 * C::TILE + (DV ? 1 : 2) * BN * 4);
        for (int p = 0; p < NP; ++p) {
          tma_panel(sQ + s * C::TILE + p * BN * 128, &map_q, &full[s],
                    64 * p, h, qt0, b);
          tma_panel(sO + s * C::TILE + p * BN * 128, &map_do, &full[s],
                    64 * p, h, qt0, b);
        }
        const long long at = ((long long)b * Hq + h) * SqP + qt0;
        bulk_load(sL + s * 2 * BN, lse_p + at, BN * 4, &full[s]);
        if (!DV)
          bulk_load(sL + s * 2 * BN + BN, delta_p + at, BN * 4, &full[s]);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int krow = k0 + warp * 16 + (lane >> 2);

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int st = t % ST;
    const int qt0 = qbeg + (t % nq) * BN;
    if (t == 0) mbar_wait(&kvbar, 0);
    mbar_wait(&full[st], (t / ST) & 1);
    // a tile none of whose pairs is valid for the block's keys
    const bool skip = (causal && k0 > qt0 + BN - 1) ||
                      (has_window && k0 + BM - 1 <= qt0 - window);
    if (!skip) {
      const unsigned char* cQ = sQ + st * C::TILE;
      const unsigned char* cO = sO + st * C::TILE;
      const float* lq = sL + st * 2 * BN;
      const bool whole = k0 + BM <= Skv && qt0 + BN <= Sq &&
                         (!causal || k0 + BM - 1 <= qt0) &&
                         (!has_window || k0 > qt0 + BN - 1 - window);
      float s[NV], dp[DV ? 1 : NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) s[i] = 0.f;
      wg_fence();
      issue_nt<DP, BN>(s, sK, cQ);
      if constexpr (!DV) {
#pragma unroll
        for (int i = 0; i < NV; ++i) dp[i] = 0.f;
        issue_nt<DP, BN>(dp, sV, cO);
      }
      wg_commit();
      wg_wait0();
      wg_touch<NV>(s);
      if constexpr (!DV) wg_touch<NV>(dp);
      uint32_t fa[BN / 16][4], fl[BN / 16][4];
      grad_tile_any<NV, true, DV, true>(has_softcap, whole, s, dp, fa, fl, lq,
                                        lq + BN, krow, qt0, Sq, Skv, tq,
                                        causal, has_window, window, softcap,
                                        scale);
#pragma unroll
      for (int p = 0; p < NP; ++p) wg_touch(acc[p]);
      wg_fence();
      // dV += P^T dO or dK += dS^T Q, the high halves then the low
      const unsigned char* cB = DV ? cO : cQ;
      issue_nn<DP, BN>(acc, fa, cB);
      issue_nn<DP, BN>(acc, fl, cB);
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int p = 0; p < NP; ++p) wg_touch(acc[p]);
    }
    mbar_arrive(&empty[st]);  // this thread is done with stage st
  }
  // the warpgroup's last products have read K (and V)
  asm volatile("bar.sync 1, %0;\n" ::"n"(GNT) : "memory");
  const long long ks = (long long)Hkv * D;
  store_tile<DP>(sK, acc,
                 out + ((long long)b * Skv + k0) * ks + (long long)hk * D,
                 Skv - k0, ks, D, warp, lane);
}

// dQ: block (query head, batch, q tile of 64 rows; the slowest axis, taken
// in reverse, so the longest causal rows go first).  Q and dO are loaded
// once; the KV tiles its rows see stream through the ring.  Per tile: S =
// Q K^T and dP = dO V^T (wgmma from shared memory), dS in registers, dQ +=
// dS K (wgmma, dS from registers as bf16, K as the MN-major B).
template <int DP>
__global__ void __launch_bounds__(BwdWgCfg<DP>::THREADS,
                                  BwdWgCfg<DP>::BLOCKS)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do,
                const float* __restrict__ lse_p,
                const float* __restrict__ delta_p,
                __nv_bfloat16* __restrict__ dq, int Sq, int SqP, int Skv,
                int Hq, int Hkv, int D, int causal, int has_window,
                int window, int has_softcap, float softcap, float scale) {
  using C = BwdWgCfg<DP>;
  constexpr int NP = C::NP, ST = C::ST, BM = C::BM, BN = C::BN;
  constexpr int NV = BN / 2;
  extern __shared__ __align__(16) unsigned char wsm[];
  __shared__ uint64_t full[ST], empty[ST], qbar;
  unsigned char* base = wsm + ((1024 - (smem_u32(wsm) & 1023)) & 1023);
  unsigned char* sQ = base;                   // [TILE]
  unsigned char* sO = sQ + C::TILE;           // dO, [TILE]
  unsigned char* sK = sO + C::TILE;           // [ST][TILE]
  unsigned char* sV = sK + ST * C::TILE;      // [ST][TILE]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int hk = h / (Hq / Hkv);
  int kend = Skv;
  if (causal) kend = min(kend, min(q0 + BM, Sq));
  const int kbeg = has_window ? max(0, q0 - window + 1) / BN * BN : 0;
  const int nt = kend > kbeg ? (kend - kbeg + BN - 1) / BN : 0;
  init_ring(full, empty, &qbar, ST);

  if (threadIdx.x >= GNT) {  // the producer warp
    if (threadIdx.x == GNT && nt > 0) {
      mbar_expect(&qbar, 2 * C::TILE);
      for (int p = 0; p < NP; ++p) {
        tma_panel(sQ + p * BM * 128, &map_q, &qbar, 64 * p, h, q0, b);
        tma_panel(sO + p * BM * 128, &map_do, &qbar, 64 * p, h, q0, b);
      }
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        mbar_expect(&full[s], 2 * C::TILE);
        for (int p = 0; p < NP; ++p) {
          tma_panel(sK + s * C::TILE + p * BN * 128, &map_k, &full[s],
                    64 * p, hk, kbeg + t * BN, b);
          tma_panel(sV + s * C::TILE + p * BN * 128, &map_v, &full[s],
                    64 * p, hk, kbeg + t * BN, b);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int qrow = q0 + warp * 16 + (lane >> 2);
  // this thread's rows qrow and qrow + 8; the padded layout holds both
  const long long at = ((long long)b * Hq + h) * SqP + qrow;
  const float lq[2] = {lse_p[at], lse_p[at + 8]};
  const float dl[2] = {delta_p[at], delta_p[at + 8]};

  float dqa[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) dqa[p][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int st = t % ST;
    const int kt0 = kbeg + t * BN;
    if (t == 0) mbar_wait(&qbar, 0);
    mbar_wait(&full[st], (t / ST) & 1);
    const unsigned char* cK = sK + st * C::TILE;
    const unsigned char* cV = sV + st * C::TILE;
    float s[NV], dp[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
    issue_nt<DP, BN>(s, sQ, cK);
    issue_nt<DP, BN>(dp, sO, cV);
    wg_commit();
    wg_wait0();
    wg_touch<NV>(s);
    wg_touch<NV>(dp);
    const bool whole = q0 + BM <= Sq && kt0 + BN <= Skv &&
                       (!causal || kt0 + BN - 1 <= q0) &&
                       (!has_window || kt0 > q0 + BM - 1 - window);
    uint32_t da[BN / 16][4];
    grad_tile_any<NV, false, false, false>(has_softcap, whole, s, dp, da,
                                           nullptr, lq, dl, qrow, kt0, Sq,
                                           Skv, tq, causal, has_window,
                                           window, softcap, scale);
#pragma unroll
    for (int p = 0; p < NP; ++p) wg_touch(dqa[p]);
    wg_fence();
    issue_nn<DP, BN>(dqa, da, cK);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < NP; ++p) wg_touch(dqa[p]);
    mbar_arrive(&empty[st]);  // this thread is done with stage st
  }
  // the warpgroup's last products have read Q and dO
  asm volatile("bar.sync 1, %0;\n" ::"n"(GNT) : "memory");
  const long long qs = (long long)Hq * D;
  store_tile<DP>(sQ, dqa,
                 dq + ((long long)b * Sq + q0) * qs + (long long)h * D,
                 Sq - q0, qs, D, warp, lane);
}

// ----------------------------------------------------------- launchers

// The map of a (B, S, H, D) bf16 tensor read as 64-column x `rows`-row
// panels of one head, in the 128-byte swizzle; reads past S or D give 0.
static bool panel_map(CUtensorMap* map, const void* x, int B, int S, int H,
                      int D, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                           (cuuint64_t)S * H * D * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_flash_bf16(const void* q, const void* k, const void* v, void* o,
                      const int* kv_len, int kv_len_all, const int* q_off,
                      int q_off_all, int B, int Sq, int Skv, int Hq, int Hkv,
                      int D, int causal, int has_window, int window,
                      int has_softcap, float softcap, float scale,
                      float* lse, cudaStream_t stream) {
  constexpr size_t smem = WgCfg<DP>::smem;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (Skv == 0)  // no key: every row is zero
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Sq * Hq * D * 2, stream);
  CUtensorMap mq, mk, mv;
  if (!panel_map(&mq, q, B, Sq, Hq, D, GQ) ||
      !panel_map(&mk, k, B, Skv, Hkv, D, WgCfg<DP>::BK) ||
      !panel_map(&mv, v, B, Skv, Hkv, D, WgCfg<DP>::BK))
    return (int)cudaErrorInvalidValue;
  dim3 grid(Hq, B, (Sq + GQ - 1) / GQ);
  flash_fwd_bf16<DP><<<grid, GNT + 32, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), kv_len, kv_len_all, q_off,
      q_off_all, Sq, Skv, Hq, Hkv, D, causal, has_window, window,
      has_softcap, softcap, scale, lse);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_flash_f32(const void* q, const void* k, const void* v, void* o,
                     const int* kv_len, int kv_len_all, const int* q_off,
                     int q_off_all, int B, int Sq, int Skv, int Hq, int Hkv,
                     int D, int causal, int has_window, int window,
                     int has_softcap, float softcap, float scale,
                     float* lse, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = flash_f32_smem_bytes<DP>();
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_f32<DP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), kv_len,
      kv_len_all, q_off, q_off_all, Sq, Skv, Hq, Hkv, D, causal, has_window,
      window, has_softcap, softcap, scale, lse);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  const int* kv_len, int kv_len_all, const int* q_off,
                  int q_off_all, int B, int Skv, int Hq, int Hkv, int D,
                  int causal, int has_window, int window, int has_softcap,
                  float softcap, float scale, float* scratch, int n_split,
                  int chunk, float* lse, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = decode_smem_bytes<T>(Hq / Hkv, D);
  const size_t combine_smem = sizeof(float) * (size_t)n_split * (Hq / Hkv);
  if (smem > (size_t)kMaxSmem || combine_smem > 48 * 1024)
    return (int)cudaErrorInvalidConfiguration;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  decode_partial<T><<<dim3(n_split, Hkv, B), DNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), scratch, kv_len, kv_len_all, q_off,
      q_off_all, Skv, Hq, Hkv, D, chunk, causal, has_window, window,
      has_softcap, softcap, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // programmatic dependent launch: the combine's blocks start while the
  // partials run and wait for them (griddepcontrol.wait), so its launch
  // latency overlaps theirs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B);
  cfg.blockDim = dim3(CNT);
  cfg.dynamicSmemBytes = combine_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_combine<T>,
                                 static_cast<const float*>(scratch),
                                 static_cast<T*>(o), lse, n_split, Hq, Hkv,
                                 D);
}


template <int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* delta, int B, int Sq, int Skv, int Hq,
               int Hkv, int D, int causal, int has_window, int window,
               int has_softcap, float softcap, float scale,
               cudaStream_t stream) {
  using C = BwdCfg<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const long long rows = (long long)B * Sq * Hq;
  flash_bwd_delta<float><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const float*>(o), tdo, lse, delta, nullptr, rows, Sq, Sq,
      Hq, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (Skv > 0) {
    flash_bwd_dkdv<DP><<<dim3((Skv + C::R - 1) / C::R, Hkv, B), BNT,
                         C::smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), Sq, Skv, Hq, Hkv, D, causal, has_window,
        window, has_softcap, softcap, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  flash_bwd_dq<DP><<<dim3((Sq + C::R - 1) / C::R, Hq, B), BNT, C::smem,
                     stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), Sq, Skv, Hq, Hkv,
      D, causal, has_window, window, has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The bf16 backward: flash_bwd_delta (delta and lse2 in the padded layout,
// SqP rows a head), then the dV, dK and dQ passes.
template <int DP>
int launch_bwd_wg(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, void* dq, void* dk,
                  void* dv, float* scratch, int B, int Sq, int Skv, int Hq,
                  int Hkv, int D, int causal, int has_window, int window,
                  int has_softcap, float softcap, float scale,
                  cudaStream_t stream) {
  using C = BwdWgCfg<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = set_smem(flash_bwd_kv_wg<DP, true>, C::smem_dv);
    if (e == cudaSuccess) e = set_smem(flash_bwd_kv_wg<DP, false>, C::smem_dk);
    if (e == cudaSuccess) e = set_smem(flash_bwd_dq_wg<DP>, C::smem_dq);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int SqP = (Sq + kLsePad - 1) / kLsePad * kLsePad;
  const long long rows = (long long)B * Hq * SqP;
  float* delta = scratch;
  float* lse_p = scratch + rows;
  flash_bwd_delta<__nv_bfloat16>
      <<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout), lse, delta, lse_p, rows,
          Sq, SqP, Hq, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (Skv == 0)  // no key: dq is zero, dk and dv are empty
    return (int)cudaMemsetAsync(dq, 0, (size_t)B * Sq * Hq * D * 2, stream);
  CUtensorMap mq, mk, mv, mo;
  if (!panel_map(&mq, q, B, Sq, Hq, D, 64) ||
      !panel_map(&mk, k, B, Skv, Hkv, D, 64) ||
      !panel_map(&mv, v, B, Skv, Hkv, D, 64) ||
      !panel_map(&mo, dout, B, Sq, Hq, D, 64))
    return (int)cudaErrorInvalidValue;
  const dim3 kv_grid(Hkv, B, (Skv + C::BM - 1) / C::BM);
  flash_bwd_kv_wg<DP, true><<<kv_grid, C::THREADS, C::smem_dv, stream>>>(
      mq, mk, mv, mo, lse_p, delta, static_cast<__nv_bfloat16*>(dv), Sq, SqP,
      Skv, Hq, Hkv, D, causal, has_window, window, has_softcap, softcap,
      scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_kv_wg<DP, false><<<kv_grid, C::THREADS, C::smem_dk, stream>>>(
      mq, mk, mv, mo, lse_p, delta, static_cast<__nv_bfloat16*>(dk), Sq, SqP,
      Skv, Hq, Hkv, D, causal, has_window, window, has_softcap, softcap,
      scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_wg<DP><<<dim3(Hq, B, (Sq + C::BM - 1) / C::BM), C::THREADS,
                        C::smem_dq, stream>>>(
      mq, mk, mv, mo, lse_p, delta, static_cast<__nv_bfloat16*>(dq), Sq, SqP,
      Skv, Hq, Hkv, D, causal, has_window, window, has_softcap, softcap,
      scale);
  return (int)cudaGetLastError();
}

// flash_attention_bwd's launches so far in this process, by path: 0 the
// FMA kernels (f32), 1 the wgmma passes at DP <= 128, 2 at DP 256
long long g_bwd_launches[3] = {0, 0, 0};

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  kv_len / q_offset: a (B,) int32
// device pointer, or null to use the scalar beside it.  lse: null, or a
// (B, Hq, Sq) f32 output for each row's log-sum-exp of its scaled (and
// capped) scores, -inf for a row with no valid key; with Skv = 0 it is
// not written.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    int kv_len_all, const int* q_off, int q_off_all, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, int dtype, int causal, int has_window, int window,
    int has_softcap, float softcap, float scale, float* lse, void* stream) {
  if (D % 8 != 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS                                                       \
  q, k, v, o, kv_len, kv_len_all, q_off, q_off_all, B, Sq, Skv, Hq, Hkv, D, \
      causal, has_window, window, has_softcap, softcap, scale, lse, s
  if (dtype == 0) {
    if (D <= 64) return launch_flash_bf16<64>(FLASH_ARGS);
    if (D <= 128) return launch_flash_bf16<128>(FLASH_ARGS);
    return launch_flash_bf16<256>(FLASH_ARGS);
  }
  if (dtype == 1) {
    if (D <= 64) return launch_flash_f32<64>(FLASH_ARGS);
    if (D <= 128) return launch_flash_f32<128>(FLASH_ARGS);
    return launch_flash_f32<256>(FLASH_ARGS);
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

// q: (B, 1, Hq, D); k, v: (B, Skv, Hkv, D).  Same conventions as above.
// scratch: (B * Hq * n_split * (D + 2)) f32 from the caller; the keys are
// cut into n_split chunks of `chunk` (a multiple of 32) that cover Skv.
// lse: (B, Hq) f32, each row's log-sum-exp over its valid keys (-inf where
// it has none), or null.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    int kv_len_all, const int* q_off, int q_off_all, int B, int Skv, int Hq,
    int Hkv, int D, int dtype, int causal, int has_window, int window,
    int has_softcap, float softcap, float scale, void* scratch, int n_split,
    int chunk, float* lse, void* stream) {
  if (D % 8 != 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > 4 * DHW || n_split < 1 ||
      chunk < DK || chunk % DK != 0 || (long long)n_split * chunk < Skv)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
#define DECODE_ARGS                                                       \
  q, k, v, o, kv_len, kv_len_all, q_off, q_off_all, B, Skv, Hq, Hkv, D,     \
      causal, has_window, window, has_softcap, softcap, scale, sc, n_split, \
      chunk, lse, s
  if (dtype == 0) return launch_decode<__nv_bfloat16>(DECODE_ARGS);
  if (dtype == 1) return launch_decode<float>(DECODE_ARGS);
#undef DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}

// The gradients of flash_attention_fwd with no kv_len and no q offset:
// q, o, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D), all of
// dtype (0 = bfloat16, 1 = float32); lse: the forward's (B, Hq, Sq) f32
// log-sum-exp; scratch: 2 B Hq SqP f32, SqP = Sq rounded up to a multiple
// of 128 (delta, and for the wgmma kernels a padded copy of lse).  Every
// output row is written.  Returns the CUDA error of the launches (0 on
// success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* scratch, int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
    int causal, int has_window, int window, int has_softcap, float softcap,
    float scale, void* stream) {
  if (D % 8 != 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_ARGS                                                             \
  q, k, v, o, dout, lse, dq, dk, dv, scratch, B, Sq, Skv, Hq, Hkv, D, causal, \
      has_window, window, has_softcap, softcap, scale, s
  if (dtype == 0) {
    ++g_bwd_launches[D <= 128 ? 1 : 2];
    if (D <= 64) return launch_bwd_wg<64>(BWD_ARGS);
    if (D <= 128) return launch_bwd_wg<128>(BWD_ARGS);
    return launch_bwd_wg<256>(BWD_ARGS);
  }
  if (dtype == 1) {
    ++g_bwd_launches[0];
    if (D <= 64) return launch_bwd<64>(BWD_ARGS);
    if (D <= 128) return launch_bwd<128>(BWD_ARGS);
    return launch_bwd<256>(BWD_ARGS);
  }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// flash_attention_bwd's launches so far in this process on `path`: 0 the
// FMA kernels, 1 the wgmma passes at DP <= 128, 2 the wgmma passes at DP
// 256.
extern "C" int flash_attention_bwd_launches(int path) {
  return path >= 0 && path < 3 ? (int)g_bwd_launches[path] : -1;
}
