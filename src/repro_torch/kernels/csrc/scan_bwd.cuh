// The layouts and schedules of the sequential backward kernels of the two
// scans: mamba2_bwd_scan (mamba2_scan.cu, the f32 and short bf16 path) and
// rwkv6_bwd_scan (rwkv6_scan.cu).  One block per (batch, head, slice of
// state rows), G lanes to a row, lane g owning the columns 4 (g + G j) + e
// (j < NV, e < 4) of its row, as E = 4 NV f32 registers.  Both
// recurrences keep rows independent, so a row's state and its adjoint
// stay in its lanes' registers from the first step to the last.  The
// reverse walk needs the state before each step in reverse order, and
// never steps the state back (that divides by the decay, which underflows
// to 0).
//
// mamba2_bwd_scan (BW_*): BW_NT threads, BW_G lanes a row.  A forward pass
// writes the state every BW_K1 steps to device memory; then, for each of
// those chunks from the last, the block steps forward from its checkpoint
// writing the state every BW_K2 steps to shared memory, and for each of
// those sub-chunks from the last, steps forward again keeping the BW_K2
// states in registers, then walks them back.  Each step is computed three
// times forward and once backward.
//
// rwkv6_bwd_scan (RB_*): RB_NT threads, RB_G lanes a row, two blocks an SM
// at D <= 64.  A forward pass writes the state every RB_K steps to device
// memory; then, for each of those pieces from the last, the block steps
// forward from its checkpoint keeping the RB_K states in registers, then
// walks them back.  Each step is computed twice forward and once
// backward.  The inputs come RB_CH steps at a time by cp.async into a
// landing buffer, converted to f32 once a chunk, the next chunk's loads in
// flight while this one is walked; a piece's sums across warps and its
// dr, dk and dw leave shared memory once a piece, behind two barriers,
// none a step.
//
// Sums across lanes and rows run in a fixed order, with no atomics, so two
// runs give the same bits: the lanes of a row by a butterfly (each lane
// ends with the same bits), the rows of a warp by shuffles (two, or four
// as ((r0 + r1) + (r2 + r3))), the warps of a block in shared memory in
// warp order, the blocks in a second kernel in block order.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int BW_NT = 512;              // threads per block
constexpr int BW_G = 16;                // lanes per state row
constexpr int BW_ROWS = BW_NT / BW_G;   // state rows per block
constexpr int BW_WARPS = BW_NT / 32;    // two rows a warp
constexpr int BW_K1 = 64;               // steps between device checkpoints
constexpr int BW_K2 = 8;                // steps between shared checkpoints
constexpr int BW_NSUB = BW_K1 / BW_K2;  // shared checkpoints a chunk

constexpr int RB_NT = 256;              // threads per block
constexpr int RB_G = 8;                 // lanes per state row
constexpr int RB_ROWS = RB_NT / RB_G;   // state rows per block
constexpr int RB_WARPS = RB_NT / 32;    // four rows a warp
constexpr int RB_K = 8;                 // steps between device checkpoints
constexpr int RB_CH = 64;               // steps loaded and converted at once

// the column of register i (< 4 NV) of lane g, G lanes a row
template <int G = BW_G>
__device__ __forceinline__ int bw_col(int g, int i) {
  return 4 * (g + G * (i >> 2)) + (i & 3);
}

// the sum over the 16 lanes of a row, the same bits on every lane
__device__ __forceinline__ float bw_row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// the sum over the two rows of a warp, the same bits on both
__device__ __forceinline__ float bw_pair_sum(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Three values a lane, each summed over the 8 lanes g of a row of
// rwkv6_bwd_scan as the butterfly xor 4, 2, 1 would, ((l0 + l4) + (l2 +
// l6)) + ((l1 + l5) + (l3 + l7)), with 4 shuffles instead of 9: at each
// level a lane keeps half of its partial sums (a fourth slot is 0) and
// swaps the other half.  Lanes g = 0, 1 return the sum of a0, g = 2, 3 of
// a1, g = 4, 5 of a2.
__device__ __forceinline__ float rb_row_sums3(float a0, float a1, float a2,
                                              int g) {
  const bool up4 = g & 4, up2 = g & 2;
  const float r0 = __shfl_xor_sync(0xffffffffu, up4 ? a0 : a2, 4);
  const float r1 = __shfl_xor_sync(0xffffffffu, up4 ? a1 : 0.f, 4);
  const float b0 = (up4 ? a2 : a0) + r0, b1 = (up4 ? 0.f : a1) + r1;
  const float c = (up2 ? b1 : b0) +
                  __shfl_xor_sync(0xffffffffu, up2 ? b0 : b1, 2);
  return c + __shfl_xor_sync(0xffffffffu, c, 1);
}

// E values a lane, each summed over the four rows of a warp of
// rwkv6_bwd_scan, ((r0 + r1) + (r2 + r3)), with 3 E / 4 shuffles instead of
// 2 E: the lanes of row q (lane >> 3) keep, after the swap with xor 8 and
// then with xor 16, out[m] = the sum of value (q & 1) E / 2 + ((q >> 1) &
// 1) E / 4 + m, m < E / 4.
template <int E>
__device__ __forceinline__ void rb_warp_rows_sums(const float (&v)[E],
                                                  float (&out)[E / 4],
                                                  int q) {
  float h[E / 2];
#pragma unroll
  for (int m = 0; m < E / 2; ++m)
    h[m] = ((q & 1) ? v[E / 2 + m] : v[m]) +
           __shfl_xor_sync(0xffffffffu, (q & 1) ? v[m] : v[E / 2 + m], 8);
#pragma unroll
  for (int m = 0; m < E / 4; ++m)
    out[m] = ((q & 2) ? h[E / 4 + m] : h[m]) +
             __shfl_xor_sync(0xffffffffu, (q & 2) ? h[m] : h[E / 4 + m], 16);
}

// a lane's registers from / to a row of `ncol` f32 (null or !ok: zeros)
template <int E, int G = BW_G>
__device__ __forceinline__ void bw_load_row(float (&st)[E], const float* row,
                                            int g, int ncol, bool ok) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = bw_col<G>(g, i);
    st[i] = row && ok && c < ncol ? row[c] : 0.f;
  }
}

template <int E, int G = BW_G>
__device__ __forceinline__ void bw_store_row(const float (&st)[E], float* row,
                                             int g, int ncol, bool ok) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = bw_col<G>(g, i);
    if (ok && c < ncol) row[c] = st[i];
  }
}

// a lane's registers to / from a checkpoint slot laid out [E / 4][NT]
// float4 (`slot` points at this thread's first float4): whole 16-byte
// words, neighbouring threads on neighbouring words
template <int E, int NT = BW_NT>
__device__ __forceinline__ void bw_put(float4* slot, const float (&st)[E]) {
#pragma unroll
  for (int j = 0; j < E / 4; ++j)
    slot[j * NT] = make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2],
                               st[4 * j + 3]);
}

template <int E, int NT = BW_NT>
__device__ __forceinline__ void bw_get(float (&st)[E], const float4* slot) {
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    const float4 q = slot[j * NT];
    st[4 * j] = q.x;
    st[4 * j + 1] = q.y;
    st[4 * j + 2] = q.z;
    st[4 * j + 3] = q.w;
  }
}

// floats of the checkpoints of `grid` blocks over S steps at NV
inline long long bw_ckpt_floats(long long grid, int S, int NV) {
  return grid * ((S + BW_K1 - 1) / BW_K1) * NV * BW_NT * 4;
}

// the same for rwkv6_bwd_scan, a checkpoint every RB_K steps
inline long long rb_ckpt_floats(long long grid, int S, int NV) {
  return grid * ((S + RB_K - 1) / RB_K) * NV * RB_NT * 4;
}

}  // namespace
