// The layout and schedule shared by the backward kernels of the two scans
// (mamba2_scan.cu, rwkv6_scan.cu): one block of BW_NT threads per (batch,
// head, slice of BW_ROWS state rows), BW_G lanes to a row, lane g owning
// the columns 4 (g + BW_G j) + e (j < NV, e < 4) of its row, as E = 4 NV
// f32 registers.  Both recurrences keep rows independent, so a row's state
// and its adjoint stay in its lanes' registers from the first step to the
// last.
//
// The reverse walk needs the state before each step in reverse order.  It
// never steps the state back (that divides by the decay, which underflows
// to 0): a forward pass writes the state every BW_K1 steps to device
// memory; then, for each of those chunks from the last, the block steps
// forward from its checkpoint writing the state every BW_K2 steps to
// shared memory, and for each of those sub-chunks from the last, steps
// forward again keeping the BW_K2 states in registers, then walks them
// back.  Each step is computed three times forward and once backward.
//
// Sums across lanes and rows run in a fixed order, with no atomics, so two
// runs give the same bits: the 16 lanes of a row by a butterfly (each lane
// ends with the same bits), the two rows of a warp by one more shuffle,
// the warps of a block in shared memory in warp order, the blocks in a
// second kernel in block order.
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

// the column of register i (< 4 NV) of lane g
__device__ __forceinline__ int bw_col(int g, int i) {
  return 4 * (g + BW_G * (i >> 2)) + (i & 3);
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

// a lane's registers from / to a row of `ncol` f32 (null or !ok: zeros)
template <int E>
__device__ __forceinline__ void bw_load_row(float (&st)[E], const float* row,
                                            int g, int ncol, bool ok) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = bw_col(g, i);
    st[i] = row && ok && c < ncol ? row[c] : 0.f;
  }
}

template <int E>
__device__ __forceinline__ void bw_store_row(const float (&st)[E], float* row,
                                             int g, int ncol, bool ok) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = bw_col(g, i);
    if (ok && c < ncol) row[c] = st[i];
  }
}

// a lane's registers to / from a checkpoint slot laid out [E / 4][BW_NT]
// float4 (`slot` points at this thread's first float4): whole 16-byte
// words, neighbouring threads on neighbouring words
template <int E>
__device__ __forceinline__ void bw_put(float4* slot, const float (&st)[E]) {
#pragma unroll
  for (int j = 0; j < E / 4; ++j)
    slot[j * BW_NT] = make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2],
                                  st[4 * j + 3]);
}

template <int E>
__device__ __forceinline__ void bw_get(float (&st)[E], const float4* slot) {
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    const float4 q = slot[j * BW_NT];
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

}  // namespace
