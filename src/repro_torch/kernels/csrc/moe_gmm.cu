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
// What the design does about it:
//
// - The plan (moe_gmm_plan, one block) is a stable counting sort of the
//   rows by expert: slot off[e] + (rank of the row among the rows of e),
//   so sorted ids give the identity and each expert's rows are one
//   contiguous range of x.  Ids outside [0, E) go to an extra bucket E.
//   Row tiles of BM rows (128 or 64, from T and E only) are cut per
//   bucket, and the plan writes each tile's bucket, rows and, when they
//   are one run of x, its first row: a product's block reads that in one
//   load.  The model builds one plan per layer for its three products.
// - bf16 with K and N multiples of 8 (gmm_wgmma): a block per (column
//   tile, row tile), the column tile fastest, so the blocks of one row
//   tile run together and x comes from device memory about once.
//   A producer warp fills a ring of ST = 4 shared-memory stages: w[e] by
//   TMA (a 3-d map over (E, K, N), read as the MN-major B operand, no
//   transpose), and the tile's x rows by one TMA box when they are one
//   run (always so for sorted ids), else gathered through perm by cp.async
//   into the same 128-byte swizzle.  BM / 64 consumer warpgroups run
//   wgmma (64 x BN x 16 per instruction, f32 accumulators in registers)
//   and hand each stage back through an mbarrier as soon as its products
//   are done, one group of products in flight; a warpgroup with no row in
//   a short tile only hands the stages back.  The epilogue stages the
//   bf16 tile in the ring and writes 16-byte row pieces through perm.
//   Many rows per expert (prefill): BM = 128, BN = 256, one block an SM.
//   Few (decode, arctic): BM = 64, BN = 128, two blocks an SM.  A block
//   runs the whole of K: splitting K across blocks, with a reduce of f32
//   partials in split order, measured no faster even where the tiles
//   leave SMs without a block (decode at 1 to 4 tokens; PERF.md).  Every
//   product launches as a programmatic dependent of the kernel before it,
//   so its blocks wait on the card, not on the launch.
// - f32 (gmm_f32_kernel, FMA pipes, full f32) and bf16 with K or N not a
//   multiple of 8 (gmm_wmma_kernel, element loads, wmma) take 64-row
//   sub-tiles of the plan's tiles and 64 columns; they serve the f32 cache
//   check and odd shapes, not the model's bf16 path.
//
// Every row's output is the same dot products in the same order whatever
// its tile, neighbours or plan, so the result is bit-reproducible.
//
// The backward (moe_gmm_bwd, the section at the end; the JAX package has
// no backward kernel, and trains through the gradient of its ref) runs on
// the same plan: in bf16 two persistent kernels, dX over (row tile, column
// tile) items and dW over (expert, K tile, N tile) items, each walking the
// expert's rows in order, fed by TMA and shared across clusters of blocks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int MAXE = 1024;          // largest E (E + 1 buckets in shared)
constexpr int PLAN_NT = 1024;
constexpr int SUB = 64;             // rows and columns of a generic tile
constexpr int GBK = 64;             // K per stage of gmm_wgmma (one panel)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ int bucket(int e, int E) {
  return (e >= 0 && e < E) ? e : E;
}

// --------------------------------------------------------------------------
// plan: stable counting sort of the rows by expert
// --------------------------------------------------------------------------

// off[b], b in [0, E]: first slot of bucket b in perm; off[E+1] = T.
// toff[b]: first row tile of bucket b (tiles of bm rows); toff[E+1] = the
// number of tiles.  perm[off[b] .. off[b+1]) holds the rows of bucket b
// (bucket E: ids out of range) in increasing order.  info[t], t below the
// host's bound on the tiles: tile t's (bucket, first slot, rows, first x
// row when its rows are one run of x, else -1); bucket -1 past the last
// tile.  So a product's block reads its tile in one load.
//
// Warp w owns the w-th of 32 contiguous segments of the rows.  Pass 1
// counts each bucket's rows in each segment (wc[b][w], warp-aggregated by
// __match_any_sync, no atomics); pass 2 turns the counts into each
// segment's first slot in each bucket; pass 3 walks the segments again in
// order and places each row at its slot plus the rows of its bucket in
// lower lanes.  The ids of PLAN_BATCH steps of 32 rows are loaded before
// any is used.  Ids whose buckets never decrease, as the model's sorted
// ids, skip the passes: the permutation is the identity and the offsets
// are where the bucket grows.
constexpr int PLAN_BATCH = 16;

// Warp 0 of plan_kernel: from each bucket's row count cnt[b], its first
// slot (off, first) and first tile of bm rows (toff, tfirst), with the
// totals at [nb].  Each lane a run of buckets, then a shuffle scan of the
// lanes' totals.
__device__ void scan_buckets(const int* cnt, int* first, int* tfirst,
                             int* off, int* toff, int nb, int bm) {
  const int lane = threadIdx.x & 31;
  const int per = (nb + 31) / 32;
  const int b0 = min(lane * per, nb), b1 = min(b0 + per, nb);
  int rows = 0, tiles = 0;
  for (int bk = b0; bk < b1; ++bk) {
    rows += cnt[bk];
    tiles += (cnt[bk] + bm - 1) / bm;
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
  for (int bk = b0; bk < b1; ++bk) {
    off[bk] = first[bk] = r_run;
    toff[bk] = tfirst[bk] = t_run;
    r_run += cnt[bk];
    t_run += (cnt[bk] + bm - 1) / bm;
  }
  if (lane == 31) {
    off[nb] = first[nb] = r_inc;
    toff[nb] = tfirst[nb] = t_inc;
  }
}

__global__ void __launch_bounds__(PLAN_NT) plan_kernel(
    const int* __restrict__ ids, int T, int E, int bm, int bound,
    int* __restrict__ perm, int* __restrict__ off, int* __restrict__ toff,
    int4* __restrict__ info) {
  // the product that follows may launch now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ int wc[];      // [E + 1][32]
  __shared__ int cnt[MAXE + 1];
  __shared__ int first[MAXE + 2];
  __shared__ int tfirst[MAXE + 2];
  const int nb = E + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  bool up = true;
  for (int base = threadIdx.x; base < T; base += PLAN_NT * PLAN_BATCH) {
    int b[PLAN_BATCH], next[PLAN_BATCH];
#pragma unroll
    for (int u = 0; u < PLAN_BATCH; ++u) {
      const int i = base + u * PLAN_NT;
      b[u] = i < T ? bucket(ids[i], E) : 0;
      next[u] = i + 1 < T ? bucket(ids[i + 1], E) : nb;
    }
#pragma unroll
    for (int u = 0; u < PLAN_BATCH; ++u) up = up && b[u] <= next[u];
  }
  const bool identity = __syncthreads_and(up);
  if (identity) {
    // bucket b starts at the first row of a bucket >= b
    if (T == 0)
      for (int bk = threadIdx.x; bk <= nb; bk += PLAN_NT) first[bk] = 0;
    for (int base = threadIdx.x; base < T; base += PLAN_NT * PLAN_BATCH) {
      int b[PLAN_BATCH], before[PLAN_BATCH];
#pragma unroll
      for (int u = 0; u < PLAN_BATCH; ++u) {
        const int i = base + u * PLAN_NT;
        b[u] = i < T ? bucket(ids[i], E) : 0;
        before[u] = i > 0 && i < T ? bucket(ids[i - 1], E) : -1;
      }
#pragma unroll
      for (int u = 0; u < PLAN_BATCH; ++u) {
        const int i = base + u * PLAN_NT;
        if (i >= T) break;
        for (int bk = before[u] + 1; bk <= b[u]; ++bk) first[bk] = i;
        if (i == T - 1)
          for (int bk = b[u] + 1; bk <= nb; ++bk) first[bk] = T;
        perm[i] = i;
      }
    }
    __syncthreads();
    for (int bk = threadIdx.x; bk < nb; bk += PLAN_NT)
      cnt[bk] = first[bk + 1] - first[bk];
    __syncthreads();
    if (warp == 0) scan_buckets(cnt, first, tfirst, off, toff, nb, bm);
  } else {
    const unsigned below = (1u << lane) - 1;
    const int seg = (T + 31) / 32;
    const int r0 = min(T, warp * seg), r1 = min(T, r0 + seg);
    for (int i = threadIdx.x; i < nb * 32; i += PLAN_NT) wc[i] = 0;
    __syncthreads();
    // pass 1: wc[b][w] = rows of bucket b in segment w
    for (int base = r0; base < r1; base += 32 * PLAN_BATCH) {
      int b[PLAN_BATCH];
#pragma unroll
      for (int u = 0; u < PLAN_BATCH; ++u) {
        const int i = base + u * 32 + lane;
        b[u] = i < r1 ? bucket(ids[i], E) : -1;
      }
#pragma unroll
      for (int u = 0; u < PLAN_BATCH; ++u) {
        if (base + u * 32 >= r1) break;
        const unsigned peers = __match_any_sync(0xffffffffu, b[u]);
        if (b[u] >= 0 && lane == __ffs(peers) - 1)
          wc[b[u] * 32 + warp] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    // pass 2: a warp a bucket: wc[b][w] = rows of b in segments below w
    for (int bk = warp; bk < nb; bk += PLAN_NT / 32) {
      const int v = wc[bk * 32 + lane];
      int inc = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += x;
      }
      wc[bk * 32 + lane] = inc - v;
      if (lane == 31) cnt[bk] = inc;
    }
    __syncthreads();
    if (warp == 0) scan_buckets(cnt, first, tfirst, off, toff, nb, bm);
    __syncthreads();
    // pass 3: place the rows, segment by segment, in order
    for (int base = r0; base < r1; base += 32 * PLAN_BATCH) {
      int b[PLAN_BATCH];
#pragma unroll
      for (int u = 0; u < PLAN_BATCH; ++u) {
        const int i = base + u * 32 + lane;
        b[u] = i < r1 ? bucket(ids[i], E) : -1;
      }
#pragma unroll
      for (int u = 0; u < PLAN_BATCH; ++u) {
        if (base + u * 32 >= r1) break;
        const unsigned peers = __match_any_sync(0xffffffffu, b[u]);
        int slot = 0;
        if (b[u] >= 0) slot = first[b[u]] + wc[b[u] * 32 + warp];
        __syncwarp();
        if (b[u] >= 0) {
          perm[slot + __popc(peers & below)] = base + u * 32 + lane;
          if (lane == __ffs(peers) - 1)
            wc[b[u] * 32 + warp] += __popc(peers);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // the tiles, a thread each: its bucket is the last whose first tile is
  // at or before it
  for (int t = threadIdx.x; t < bound; t += PLAN_NT) {
    if (t >= tfirst[nb]) {
      info[t] = make_int4(-1, 0, 0, -1);
      continue;
    }
    int bk = 0;
    for (int hi = nb - 1; bk < hi;) {
      const int mid = (bk + hi + 1) >> 1;
      if (tfirst[mid] <= t) bk = mid;
      else hi = mid - 1;
    }
    const int r0 = first[bk] + (t - tfirst[bk]) * bm;
    const int n = min(bm, first[bk + 1] - r0);
    int run = bk < E ? (identity ? r0 : perm[r0]) : -1;
    if (!identity)
      for (int i = 1; i < n && run >= 0; ++i)
        if (perm[r0 + i] != run + i) run = -1;
    info[t] = make_int4(bk, r0, n, run);
  }
}

// --------------------------------------------------------------------------
// bf16, K and N multiples of 8: wgmma fed by TMA (or a cp.async gather)
// --------------------------------------------------------------------------

// d (64 x N f32) (+)= A (64 x 16) * B (16 x N), both from shared memory in
// the 128-byte swizzle: A K-major (TA 0) or M-major (TA 1, the transposed
// operand, allowed for 16-bit types), B K-major (TB 0) or N-major (TB 1)
template <int N, int TA, int TB>
__device__ inline void wgmma_bf(float* d, uint64_t da, uint64_t db,
                                int scale_d) {
  static_assert(N == 128 || N == 256, "the tile widths of this file");
  if constexpr (N == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// Stage s of the ring: the A tile (BM rows of 64 K-columns, 128 bytes a
// row, swizzled), then the B tile: BN / 64 panels of 64 K-rows x 64
// columns, 8 KB each, swizzled (w read as the MN-major B).  Stages start
// 1024-byte aligned.  The epilogue stages the bf16 tile in the ring, rows
// LDC apart.
template <int BM, int BN, int ST>
struct GmmCfg {
  static constexpr int NWG = BM / 64;               // consumer warpgroups
  static constexpr int CONSUMERS = NWG * 128;
  static constexpr int THREADS = CONSUMERS + 32;    // + the producer warp
  static constexpr int A_BYTES = BM * GBK * 2;
  static constexpr int B_BYTES = GBK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDC = BN + 8;
  static constexpr size_t smem = 1024 + (size_t)ST * STAGE;
  static_assert(BM * LDC * 2 <= ST * STAGE, "epilogue tile fits the ring");
  static_assert(smem <= kMaxSmem, "ring fits shared memory");
};

// The consumer warpgroups of gmm_wgmma: wgmma over the ring's stages,
// each stage handed back to the producer as soon as its products are
// done, one group of products in flight; then the epilogue.
template <int BM, int BN, int ST>
__device__ __forceinline__ void consume(
    unsigned char* ring, uint64_t* full, uint64_t* empty, const int* rows,
    int n_rows, bool run, int nk, int n0, int N, bf16* __restrict__ out) {
  using C = GmmCfg<BM, BN, ST>;
  const int wg = threadIdx.x / 128;
  // a warpgroup with no row of the tile (a short last tile of an expert)
  // only hands each stage back once it has landed, so its arrivals keep
  // the pace of the other warpgroup's
  const bool idle = wg * 64 >= n_rows;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  wg_touch<BN / 2>(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    mbar_wait(&full[s], (kt / ST) & 1);
    if (idle) {
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
      continue;
    }
    if (!run) fence_proxy_async();
    const unsigned char* sA = ring + s * C::STAGE + wg * 64 * 128;
    const unsigned char* sB = ring + s * C::STAGE + C::A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk)
      wgmma_bf<BN, 0, 1>(acc, wg_desc(sA + kk * 32, 16, 1024),
                         wg_desc(sB + kk * 2048, 8192, 1024), 1);
    wg_commit();
    // the previous step's products are done: hand its stage back
    wg_wait<1>();
    wg_touch<BN / 2>(acc);
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % ST]);
  }
  wg_wait<0>();
  wg_touch<BN / 2>(acc);

  // this thread's rows rbase and rbase + 8 of the tile, columns
  // 8 j + 2 tq (+1)
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rbase = wg * 64 + (threadIdx.x / 32 % 4) * 16 + gq;
  // every consumer is done with the ring: stage the bf16 tile there, then
  // write it out in 16-byte row pieces
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::CONSUMERS) : "memory");
  bf16* sC = reinterpret_cast<bf16*>(ring);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          sC + (rbase + 8 * r) * C::LDC + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::CONSUMERS) : "memory");
  for (int i = threadIdx.x; i < BM * BN / 8; i += C::CONSUMERS) {
    const int r = i / (BN / 8), c = i % (BN / 8) * 8;
    const int row = rows[r], n = n0 + c;
    if (row >= 0 && n < N)
      *reinterpret_cast<uint4*>(out + (long long)row * N + n) =
          *reinterpret_cast<const uint4*>(sC + r * C::LDC + c);
  }
}

// Block (column tile, row tile): the column tile fastest, so the blocks of
// one row tile run together and x comes from device memory about once.
// It writes its bf16 tile of out = x @ w[e] over the whole of K; tiles of
// bucket E (ids out of range) write zeros.
template <int BM, int BN, int ST>
__global__ void __launch_bounds__(GmmCfg<BM, BN, ST>::THREADS, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_w,
          const bf16* __restrict__ x, bf16* __restrict__ out,
          const int* __restrict__ perm, const int4* __restrict__ info,
          int K, int N, int E) {
  using C = GmmCfg<BM, BN, ST>;
  extern __shared__ __align__(16) unsigned char gsm[];
  __shared__ uint64_t full[ST], empty[ST];
  __shared__ int rows[BM];
  unsigned char* ring = gsm + ((1024 - (smem_u32(gsm) & 1023)) & 1023);
  // launched as a programmatic dependent of the plan (or of whatever ran
  // before): wait for its writes.  The next launch may start now: another
  // product waits for this grid in turn.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int n0 = blockIdx.x * BN;
  // the plan's tile: (bucket, first slot, rows, first x row of a run)
  const int4 tile = info[blockIdx.y];
  const int e = tile.x;
  if (e < 0) return;
  // one contiguous run of x rows comes by TMA boxes, others are gathered
  const bool run = tile.w >= 0;
  if (threadIdx.x == 0 && e < E) {
    for (int s = 0; s < ST; ++s) {
      // the producer's expect_tx, plus one cp.async arrival a lane when
      // the rows are gathered
      mbar_init(&full[s], run ? 1 : 33);
      // one arrival a consumer warpgroup
      mbar_init(&empty[s], C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < BM; i += C::THREADS)
    rows[i] = i >= tile.z ? -1 : run ? tile.w + i : perm[tile.y + i];
  __syncthreads();
  if (e == E) {  // ids out of range: zero rows
    for (int i = threadIdx.x; i < BM * BN / 8; i += C::THREADS) {
      const int r = rows[i / (BN / 8)], n = n0 + i % (BN / 8) * 8;
      if (r >= 0 && n < N)
        *reinterpret_cast<uint4*>(out + (long long)r * N + n) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int nk = (K + GBK - 1) / GBK;

  if (threadIdx.x < C::CONSUMERS) {
    consume<BM, BN, ST>(ring, full, empty, rows, tile.z, run, nk, n0, N, out);
    return;
  }
  // the producer warp
  const int lane = threadIdx.x & 31;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    const int kk = kt * GBK;
    unsigned char* sA = ring + s * C::STAGE;
    unsigned char* sB = sA + C::A_BYTES;
    if (kt >= ST) mbar_wait(&empty[s], (kt / ST - 1) & 1);
    if (lane == 0) {
      mbar_expect(&full[s], C::B_BYTES + (run ? C::A_BYTES : 0));
      for (int p = 0; p < BN / 64; ++p)
        tma_load_3d(sB + p * 8192, &map_w, &full[s], n0 + 64 * p, kk, e);
      if (run) tma_load_2d(sA, &map_x, &full[s], kk, tile.w);
    }
    if (run) continue;
    // row r's 16-byte chunk c goes to chunk c ^ (r % 8) of its 128-byte
    // row; rows past the tile and columns past K are zero
    for (int i = lane; i < BM * 8; i += 32) {
      const int r = i >> 3, c = i & 7;
      const int row = rows[r], col = kk + c * 8;
      const bool in = row >= 0 && col < K;
      cp_async16(sA + r * 128 + ((c ^ (r & 7)) << 4),
                 in ? x + (long long)row * K + col : x, in ? 16 : 0);
    }
    asm volatile(
        "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
            smem_u32(&full[s]))
        : "memory");
  }
}

// --------------------------------------------------------------------------
// bf16 with K or N not a multiple of 8: wmma, element loads
// --------------------------------------------------------------------------

constexpr int WNT = 128;            // 4 warps, 2 x 2 of 32 x 32 outputs
constexpr int WBK = 32;             // K per stage
constexpr int LDA = WBK + 8;        // shared strides, padded (multiples of 8)
constexpr int LDB = SUB + 8;
constexpr int LDC = SUB + 4;

// The 64-row sub-tiles of block row blockIdx.y's tile, one after another:
// rows[] holds the sub-tile's rows (-1 past its end) while `body(e, n0)`
// runs for the block's 64 columns from n0 = blockIdx.x * 64.  Rows of
// bucket E are written as zeros.
template <typename T, typename Body>
__device__ void for_sub_tiles(const int* __restrict__ perm,
                              const int4* __restrict__ info, int E, T* out,
                              int N, int* rows, Body body) {
  const int4 tile = info[blockIdx.y];
  if (tile.x < 0) return;
  const int n0 = blockIdx.x * SUB;
  for (int sub = 0; sub < tile.z; sub += SUB) {
    for (int i = threadIdx.x; i < SUB; i += blockDim.x)
      rows[i] = sub + i < tile.z ? perm[tile.y + sub + i] : -1;
    __syncthreads();
    if (tile.x == E) {
      for (int i = threadIdx.x; i < SUB * SUB; i += blockDim.x) {
        const int r = rows[i / SUB], n = n0 + i % SUB;
        if (r >= 0 && n < N) out[(long long)r * N + n] = T(0.0f);
      }
    } else {
      body(tile.x, n0);
    }
    __syncthreads();
  }
}

// TB 0: out = x @ w[e], w (E, K, N); TB 1: out = x @ w[e]^T, w (E, N, K)
// (the backward's dX), its tile read along K
template <int TB>
__global__ void __launch_bounds__(WNT) gmm_wmma_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
    bf16* __restrict__ out, const int* __restrict__ perm,
    const int4* __restrict__ info, int K, int N, int E) {
  __shared__ __align__(128) bf16 As[SUB * LDA];
  __shared__ __align__(128) bf16 Bs[WBK * LDB];
  __shared__ __align__(128) float Cs[SUB * LDC];
  __shared__ int rows[SUB];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  for_sub_tiles(perm, info, E, out, N, rows, [&](int e, int n0) {
    const uint16_t* we = w + (long long)e * K * N;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < K; k0 += WBK) {
      for (int i = tid; i < SUB * WBK; i += WNT) {
        const int r = i / WBK, k = k0 + i % WBK, row = rows[r];
        const uint16_t v = row >= 0 && k < K ? x[(long long)row * K + k] : 0;
        As[r * LDA + i % WBK] = *reinterpret_cast<const bf16*>(&v);
      }
      for (int i = tid; i < WBK * SUB; i += WNT) {
        const int kr = TB ? i % WBK : i / SUB, c = TB ? i / WBK : i % SUB;
        const int n = n0 + c;
        const long long at = TB ? (long long)n * K + k0 + kr
                                : (long long)(k0 + kr) * N + n;
        const uint16_t v = k0 + kr < K && n < N ? we[at] : 0;
        Bs[kr * LDB + c] = *reinterpret_cast<const bf16*>(&v);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[(wr * 32 + i * 16) * LDA + kk],
                                 LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wc * 32 + j * 16],
                                 LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            &Cs[(wr * 32 + i * 16) * LDC + wc * 32 + j * 16], acc[i][j], LDC,
            wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < SUB * SUB; i += WNT) {
      const int r = rows[i / SUB], n = n0 + i % SUB;
      if (r >= 0 && n < N)
        out[(long long)r * N + n] =
            __float2bfloat16(Cs[i / SUB * LDC + i % SUB]);
    }
  });
}

// --------------------------------------------------------------------------
// f32: FMA pipes, full f32
// --------------------------------------------------------------------------

constexpr int FNT = 256;            // 16 x 16 threads of 4 x 4 outputs
constexpr int FBK = 16;             // K per stage

// TB as in gmm_wmma_kernel
template <int TB>
__global__ void __launch_bounds__(FNT) gmm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, const int* __restrict__ perm,
    const int4* __restrict__ info, int K, int N, int E) {
  __shared__ float As[FBK][SUB + 4];      // transposed: As[k][row]
  __shared__ float Bs[FBK][SUB + 4];
  __shared__ int rows[SUB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for_sub_tiles(perm, info, E, out, N, rows, [&](int e, int n0) {
    const float* we = w + (long long)e * K * N;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
      for (int v = 0; v < SUB * FBK / FNT; ++v) {
        const int idx = tid + v * FNT;
        const int r = idx / FBK, kk = idx % FBK, row = rows[r];
        As[kk][r] = row >= 0 && k0 + kk < K ? x[(long long)row * K + k0 + kk]
                                            : 0.0f;
      }
#pragma unroll
      for (int v = 0; v < FBK * SUB / FNT; ++v) {
        const int idx = tid + v * FNT;
        const int kr = TB ? idx % FBK : idx / SUB;
        const int c = TB ? idx / FBK : idx % SUB;
        const long long at = TB ? (long long)(n0 + c) * K + k0 + kr
                                : (long long)(k0 + kr) * N + n0 + c;
        Bs[kr][c] = k0 + kr < K && n0 + c < N ? we[at] : 0.0f;
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
  });
}

// ----------------------------------------------------------- launchers

// The map of a row-major (rows, cols) bf16 matrix (a 3rd dimension of
// `depth` such matrices when depth > 0) read in boxes of 64 columns x
// `box_rows` rows, in the 128-byte swizzle; reads past an edge give 0.
bool gmm_map(CUtensorMap* map, const void* p, long long rows, long long cols,
             long long depth, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                        (cuuint64_t)depth};
  cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                           (cuuint64_t)(rows * cols * 2)};
  cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, depth > 0 ? 3 : 2,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches as a programmatic dependent of the previous launch on the
// stream (gmm_wgmma waits for it).
template <int BM, int BN, int ST>
int launch_wgmma(const void* x, const void* w, void* out, const int* perm,
                 const int4* info, int T, int K, int N, int E, int tiles,
                 cudaStream_t s) {
  using C = GmmCfg<BM, BN, ST>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        gmm_wgmma<BM, BN, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap mx, mw;
  if (!gmm_map(&mx, x, T, K, 0, BM) || !gmm_map(&mw, w, K, N, E, GBK))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, tiles);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, gmm_wgmma<BM, BN, ST>, mx, mw, static_cast<const bf16*>(x),
      static_cast<bf16*>(out), perm, info, K, N, E);
}

}  // namespace

// ids: (T,) int32 on the device.  Writes the stable plan of ids with row
// tiles of bm rows: perm (T,), off (E + 2,) and toff (E + 2,) int32, and
// info (bound, 4) int32, one (bucket, first slot, rows, first x row of a
// run or -1) per tile, bucket -1 past the last.  bound is at least the
// tile count of any ids, ceil(T / bm) + min(E + 1, T).  E at most 1024.
// Returns the CUDA error of the launch.
extern "C" int moe_gmm_plan(const int* ids, int* perm, int* off, int* toff,
                            int* info, int T, int E, int bm, int bound,
                            void* stream) {
  if (T < 0 || E < 1 || E > MAXE || bm < 1 ||
      (long long)bound < (T + bm - 1) / bm + (T < E + 1 ? T : E + 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * 32 * (size_t)(E + 1);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(int) * 32 * (MAXE + 1)));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  plan_kernel<<<1, PLAN_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      ids, T, E, bm, bound, perm, off, toff, reinterpret_cast<int4*>(info));
  return (int)cudaGetLastError();
}

// x: (T, K) contiguous; w: (E, K, N) contiguous; out: (T, N) contiguous,
// in x's dtype; perm and info: the plan of the rows' ids with row tiles of
// bm rows and `tiles` entries of info (moe_gmm_plan).  dtype: 0 = bf16,
// 1 = f32 (x, w and out).  The schedule: path 0 = gmm_wgmma with
// (bm, bn) = (128, 256) or (64, 128); path 1 = the 64 x 64 generic
// kernels (gmm_wmma_kernel in bf16, gmm_f32_kernel in f32).  Returns the
// CUDA error of the launch (0 on success).
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out,
                           const int* perm, const int* info, int T, int K,
                           int N, int E, int dtype, int path, int bm, int bn,
                           int tiles, void* stream) {
  if (T < 0 || K < 0 || N < 0 || E < 1 || E > MAXE || tiles < 0 ||
      tiles > 65535)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0) {  // empty sums
    return (int)cudaMemsetAsync(out, 0, (size_t)T * N * (dtype ? 4 : 2), s);
  }
  const int4* ti = reinterpret_cast<const int4*>(info);
  if (path == 0) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                            reinterpret_cast<uintptr_t>(w) |
                            reinterpret_cast<uintptr_t>(out);
    if (dtype != 0 || K % 8 || N % 8 || align % 16)
      return (int)cudaErrorInvalidValue;
    if (bm == 128 && bn == 256)
      return launch_wgmma<128, 256, 4>(x, w, out, perm, ti, T, K, N, E,
                                       tiles, s);
    if (bm == 64 && bn == 128)
      return launch_wgmma<64, 128, 4>(x, w, out, perm, ti, T, K, N, E,
                                      tiles, s);
    return (int)cudaErrorInvalidValue;
  }
  if (path != 1 || bn != SUB)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + SUB - 1) / SUB, tiles);
  if (dtype == 1)
    gmm_f32_kernel<0><<<grid, FNT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), perm, ti, K, N, E);
  else if (dtype == 0)
    gmm_wmma_kernel<0><<<grid, WNT, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
        static_cast<bf16*>(out), perm, ti, K, N, E);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- backward
//
// The gradients of out = moe_gmm(x, w, ids) for the output gradient dY
// (T, N), as autograd differentiates ref.py::moe_gmm_ref:
//
//   dX[i] = dY[i] @ w[ids[i]]^T              (zero for ids outside [0, E))
//   dW[e] = sum over the rows i of e of x[i]^T dY[i]
//
// Both accumulate in f32 and are rounded once; neither takes an atomic,
// and every sum runs in a fixed order, so two runs give the same bits.
// Both use the forward's plan of the ids (the layer builds one for its
// three products and the backward reuses it).
//
// In bf16 with K and N multiples of 8 both kernels are persistent: as many
// blocks as the card holds at once walk a list of work items; a producer
// fills a ring of BWD_ST = 4 stages of 48 KB by TMA (or by a cp.async
// gather through perm where the rows are not one run of x); the consumer
// warpgroups run wgmma and write each item's bf16 tile out a 64-column
// panel at a time through two 8 KB buffers a warpgroup, outside the ring,
// so the ring fills for the next item meanwhile.  (Three stages beside a
// whole 64 KB tile measured slower.)  dW starts beside dX's last tiles.
//
// - dX (gmm_dx_wgmma): items (row tile of the plan, column tile of the K
//   output columns), the column tile fastest, item i to block i mod the
//   grid, so the blocks at work share a few row tiles and experts.  B is
//   w[e] read K-major (contiguous along the sum, wgmma's default major)
//   through a TMA map over (E, K, N) with its box along N.  A warpgroup
//   whose 64 rows of the tile are one run of x stores them by TMA; others
//   (gathered rows, a short tile's partial half) write 16-byte row pieces
//   through perm; tiles of bucket E write zeros.
// - dW (gmm_dw_wgmma): items (expert, K tile of DW_BK, N tile of DW_BN),
//   the experts by rows, most first.  An item is the sum over the expert's
//   rows (slots off[e] to off[e + 1]) in slot order, GBK a stage, with A =
//   x^T, M-major from shared memory (the transposed A that 16-bit types
//   allow), and B = dY, N-major.  A stage of GBK slots lies in one row
//   tile of the plan (tiles of 64 or 128 slots from off[e]), so its rows
//   are one run of x exactly when that tile's info.w >= 0, from x row
//   info.w plus the stage's offset in the tile: such a stage comes by TMA
//   boxes, and the consumers set the rows past a partial last stage (the
//   next expert's, or past T) to zero once it lands; other stages are
//   gathered through perm by cp.async with zero fill.  Clusters of DW_CK
//   blocks along K take an item together, block kr its K tile kg DW_CK +
//   kr of the N tile they share, and each of dY's TMA boxes is loaded once
//   and multicast to the cluster.  A consumer hands a stage back to every
//   block of its cluster, so no block writes a stage before all are done
//   with it.  An expert with no row writes zeros.
// - f32 and K or N not a multiple of 8: dX on the forward's generic
//   kernels with w read transposed; dW a 64 x 64 block a (N tile, K tile,
//   expert) on the FMA pipes or wmma.
//
// What bounds it on an H100: at granite-moe's training shapes (32,800
// routed rows, K 1536, N 512, E 40, bf16) each of dX and dW is 51.6
// GFLOP (0.052 ms at 989 TFLOP/s) against ~197 MB read and written once
// (0.059 ms at 3.35 TB/s): bytes, narrowly.  dW reads each dY row once a K
// tile and each x row once an N tile: ~605 MB from L2 a call with blocks
// alone, ~403 MB with dY multicast to clusters of 2 along K (DW_CK;
// PERF.md gives the other shapes measured).

namespace {

constexpr int DW_BK = 128;          // K rows of a bf16 dW tile (2 warpgroups)
constexpr int DW_BN = 256;          // N columns of a bf16 dW tile
constexpr int DW_PW = 4;            // producer warps of a dW block
constexpr int BWD_ST = 4;           // ring stages of the bf16 backward
constexpr int EPI_BUF = 8192;       // an epilogue buffer: 64 rows x 64 columns
constexpr int DW_CK = 2;            // blocks of a dW cluster, along K

// The dynamic shared memory of a persistent bf16 backward block, from a
// 1024-byte aligned base (the kernels have no static shared memory, so it
// starts at the window's base): BWD_ST stages of STAGE bytes, two epilogue
// buffers a consumer warpgroup, the ring's barriers (full, then empty),
// then EXTRA bytes.
template <int STAGE_, int NWG_, int EXTRA>
struct BwdSmem {
  static constexpr int STAGE = STAGE_, NWG = NWG_;
  static constexpr int EPI = BWD_ST * STAGE;                 // offsets
  static constexpr int BARS = EPI + NWG * 2 * EPI_BUF;
  static constexpr int TAIL = BARS + 2 * BWD_ST * 8;
  static constexpr size_t bytes = (size_t)TAIL + EXTRA;
  static_assert(bytes <= kMaxSmem, "fits shared memory");
};

// A dW block: each stage GBK rows of x (DW_BK / 64 panels of 64 rows x 64
// K-columns), then the same rows of dY (DW_BN / 64 panels of 64 columns),
// 8 KB a panel, each row 128 bytes, swizzled (the layout of a TMA box);
// the expert order (uint16, MAXE) after the barriers.
struct DwCfg : BwdSmem<GBK * (DW_BK + DW_BN) * 2, DW_BK / 64, 2 * MAXE> {
  static constexpr int CONSUMERS = NWG * 128;
  static constexpr int THREADS = CONSUMERS + 32 * DW_PW;  // + the producers
  static constexpr int A_BYTES = GBK * DW_BK * 2;
};

// A dX block: each stage BM rows of dY (64 columns of the sum, 128 bytes a
// row, swizzled), then BN rows of w[e] (K-major, as A).
template <int BM, int BN>
struct DxCfg : BwdSmem<GBK * (BM + BN) * 2, BM / 64, 0> {
  static constexpr int CONSUMERS = BM / 64 * 128;
  static constexpr int THREADS = CONSUMERS + 32;    // + the producer warp
  static constexpr int A_BYTES = BM * GBK * 2;
  static constexpr int B_BYTES = BN * GBK * 2;
};

// The base of a block's dynamic shared memory; it traps unless 1024-byte
// aligned (the 128-byte swizzle's atom, which TMA and wgmma need)
__device__ __forceinline__ unsigned char* bwd_smem() {
  extern __shared__ __align__(1024) unsigned char bwd_sm[];
  if (smem_u32(bwd_sm) & 1023) __trap();
  return bwd_sm;
}

// named barrier `id` over `n` threads
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A consumer warpgroup's epilogue: its 64 x BN f32 accumulators as bf16
// (zeros where no product wrote them, !live), a 64-column panel at a time
// through its two buffers `bufs` (64 rows x 128 bytes, row r's 16-byte
// chunk c at chunk c ^ (r % 8): a TMA box's swizzle).  `store(p, buf)`
// writes panel p out while the next is staged, as one bulk group of the
// warpgroup's thread 0; a buffer is rewritten once the group two panels
// back has read it.  The thread holds rows r0 and r0 + 8 of the 64,
// columns 8 j + 2 tq (+1).
template <int BN, typename Store>
__device__ __forceinline__ void epilogue(unsigned char* bufs,
                                         const float* acc, bool live,
                                         Store store) {
  const int tw = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = tw / 32 * 16 + gq;                   // r0 % 8 == gq
#pragma unroll
  for (int p = 0; p < BN / 64; ++p) {
    unsigned char* buf = bufs + (p & 1) * EPI_BUF;
    if (tw == 0) bulk_wait_read<1>();
    named_sync(2 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int a = 4 * (8 * p + jj) + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(buf + (r0 + 8 * r) * 128 +
                                           ((jj ^ gq) << 4) + 4 * tq) =
            live ? __floats2bfloat162_rn(acc[a], acc[a + 1])
                 : __floats2bfloat162_rn(0.f, 0.f);
      }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    store(p, buf);
    if (tw == 0) bulk_commit();
  }
}

// A stage handed back: one arrival a consumer warpgroup on its barrier in
// each of the cs blocks of the cluster
__device__ __forceinline__ void hand_back(uint64_t* bar, int cs) {
  if (threadIdx.x % 128 != 0) return;
  if (cs == 1)
    mbar_arrive(bar);
  else
    for (int r = 0; r < cs; ++r) mbar_arrive_cluster(bar, r);
}

// dX = dY @ w[e]^T on a block's items i = blockIdx.x, + gridDim.x, ..: row
// tile y = i / (column tiles) of the plan, while it is one, and column
// tile i % (column tiles).  The sum runs over S (the forward's N), the
// output has C columns (the forward's K), w is (E, C, S).
template <int BM, int BN>
__global__ void __launch_bounds__(DxCfg<BM, BN>::THREADS, 1)
gmm_dx_wgmma(const __grid_constant__ CUtensorMap map_dy,
             const __grid_constant__ CUtensorMap map_w,
             const __grid_constant__ CUtensorMap map_dx,
             const bf16* __restrict__ dy, bf16* __restrict__ dx,
             const int* __restrict__ perm, const int4* __restrict__ info,
             int S, int C, int E, int tiles) {
  using Cf = DxCfg<BM, BN>;
  unsigned char* ring = bwd_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Cf::BARS);
  uint64_t* empty = full + BWD_ST;
  // launched as a programmatic dependent: wait for the grid before
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_ST; ++s) {
      // the producer's expect_tx (a gather's cp.async's add their own)
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Cf::NWG);    // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ncol = (C + BN - 1) / BN, nk = (S + GBK - 1) / GBK;
  int it = 0;                           // stages through the ring so far

  if (threadIdx.x < Cf::CONSUMERS) {
    const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
    unsigned char* bufs = ring + Cf::EPI + wg * 2 * EPI_BUF;
    for (int i = blockIdx.x;; i += gridDim.x) {
      const int y = i / ncol;
      if (y >= tiles) break;
      // the plan's tile: (bucket, first slot, rows, first x row of a run)
      const int4 tile = info[y];
      const int e = tile.x;
      if (e < 0) break;
      // this warpgroup's rows of the tile: r0 .. r0 + rows (none if <= 0)
      const int n0 = i % ncol * BN, r0 = wg * 64;
      const int rows = min(64, tile.z - r0);
      if (e == E) {  // ids out of range: zero rows
        for (int j = tw; j < 64 * BN / 8; j += 128) {
          const int r = j / (BN / 8), c = n0 + j % (BN / 8) * 8;
          if (r < rows && c < C)
            *reinterpret_cast<uint4*>(
                dx + (long long)perm[tile.y + r0 + r] * C + c) =
                make_uint4(0, 0, 0, 0);
        }
        continue;
      }
      const bool run = tile.w >= 0;
      if (rows <= 0) {
        // no row of a short tile: hand each stage back once it has landed,
        // so the arrivals keep the other warpgroup's pace
        for (int kt = 0; kt < nk; ++kt, ++it) {
          mbar_wait(&full[it % BWD_ST], (it / BWD_ST) & 1);
          hand_back(&empty[it % BWD_ST], 1);
        }
        continue;
      }
      // the item's first product overwrites the accumulators (scale-d 0):
      // no other instruction writes them
      float acc[BN / 2];
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % BWD_ST;
        mbar_wait(&full[s], (it / BWD_ST) & 1);
        if (!run) fence_proxy_async();
        const unsigned char* sA = ring + s * Cf::STAGE + r0 * 128;
        const unsigned char* sB = ring + s * Cf::STAGE + Cf::A_BYTES;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk)
          wgmma_bf<BN, 0, 0>(acc, wg_desc(sA + kk * 32, 16, 1024),
                             wg_desc(sB + kk * 32, 16, 1024), kt + kk > 0);
        wg_commit();
        // the previous step's products are done: hand its stage back
        wg_wait<1>();
        wg_touch<BN / 2>(acc);
        if (kt > 0) hand_back(&empty[(it - 1) % BWD_ST], 1);
      }
      wg_wait<0>();
      wg_touch<BN / 2>(acc);
      hand_back(&empty[(it - 1) % BWD_ST], 1);

      // the epilogue, while the ring fills for the next tile: 64 rows of
      // one run by TMA boxes, others in 16-byte row pieces through perm
      const bool boxed = run && rows == 64;
      epilogue<BN>(bufs, acc, true, [&](int p, const unsigned char* buf) {
        const int c0 = n0 + 64 * p;
        if (boxed) {
          if (tw == 0 && c0 < C)
            tma_store_2d(&map_dx, buf, c0, tile.w + r0);
          return;
        }
        for (int j = tw; j < 64 * 8; j += 128) {
          const int r = j / 8, q = j % 8, c = c0 + q * 8;
          if (r < rows && c < C) {
            const long long row =
                run ? tile.w + r0 + r : perm[tile.y + r0 + r];
            *reinterpret_cast<uint4*>(dx + row * C + c) =
                *reinterpret_cast<const uint4*>(buf + r * 128 +
                                                ((q ^ (r & 7)) << 4));
          }
        }
      });
    }
    if (tw == 0) bulk_wait();
    return;
  }
  // the producer warp
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x;; i += gridDim.x) {
    const int y = i / ncol;
    if (y >= tiles) break;
    const int4 tile = info[y];
    const int e = tile.x;
    if (e < 0) break;
    if (e == E) continue;
    const int n0 = i % ncol * BN;
    const bool run = tile.w >= 0;
    // gathered rows: lane l holds the x rows of the tile's rows l, l + 32, ..
    int prow[BM / 32];
#pragma unroll
    for (int m = 0; m < BM / 32; ++m) {
      const int r = lane + 32 * m;
      prow[m] = !run && r < tile.z ? perm[tile.y + r] : -1;
    }
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % BWD_ST, kk = kt * GBK;
      unsigned char* sA = ring + s * Cf::STAGE;
      unsigned char* sB = sA + Cf::A_BYTES;
      // every lane waits for every stage to be free, also one that lane 0
      // alone fills (a run), and the warp moves on together: no lane runs
      // ahead of the barrier's phase, so its parity names the right one
      if (it >= BWD_ST) mbar_wait(&empty[s], (it / BWD_ST - 1) & 1);
      __syncwarp();
      if (run) {
        if (lane == 0) {
          mbar_expect(&full[s], Cf::STAGE);
          tma_load_3d(sB, &map_w, &full[s], kk, n0, e);
          tma_load_2d(sA, &map_dy, &full[s], kk, tile.w);
        }
        continue;
      }
      // row r's 16-byte chunk c goes to chunk c ^ (r % 8) of its 128-byte
      // row; rows past the tile and columns past S are zero.  Lane l takes
      // chunk l % 8 of rows l / 8 + 4 j, held by lane r % 32 in prow[j / 8]
#pragma unroll
      for (int j = 0; j < BM / 4; ++j) {
        const int r = (lane >> 3) + 4 * j, c = lane & 7;
        const int row = __shfl_sync(0xffffffffu, prow[j / 8], r & 31);
        const int col = kk + c * 8;
        const bool in = row >= 0 && col < S;
        cp_async16(sA + r * 128 + ((c ^ (r & 7)) << 4),
                   in ? dy + (long long)row * S + col : dy, in ? 16 : 0);
      }
      // each lane's copies hold the phase open before the expect_tx may
      // close it
      cp_async_arrive(&full[s]);
      __syncwarp();
      if (lane == 0) {
        mbar_expect(&full[s], Cf::B_BYTES);
        tma_load_3d(sB, &map_w, &full[s], kk, n0, e);
      }
    }
  }
}

// The work of a dW launch, as each of its blocks computes it: nc clusters
// of DW_CK blocks; this block's cluster c and rank kr in it; an expert's
// items in nkg groups of DW_CK K tiles by nn N tiles.  Round w gives
// cluster c the item w nc + c, in odd rounds w nc + nc - 1 - c, of the
// list of every expert's items, the experts by rank (order), the K group
// fastest.
struct DwWork {
  int kr, nc, c, nkg, nn;
};

// One item of a dW block: expert e's tile at (k0, n0) and its slots
// s0 .. s1
struct DwItem {
  int e, k0, n0, s0, s1;
};

__device__ __forceinline__ bool dw_item(const DwWork& wk, int w,
                                        const uint16_t* order,
                                        const int* __restrict__ off, int E,
                                        DwItem& t) {
  const int per = wk.nkg * wk.nn;
  const int i = w * wk.nc + ((w & 1) ? wk.nc - 1 - wk.c : wk.c);
  if (i >= E * per) return false;
  t.e = order[i / per];
  t.k0 = (i % per % wk.nkg * DW_CK + wk.kr) * DW_BK;
  t.n0 = i % per / wk.nkg * DW_BN;
  t.s0 = off[t.e];
  t.s1 = off[t.e + 1];
  return true;
}

// A dW block of a cluster of DW_CK: its items (DwWork), each
// dW[e][k0 .. k0 + DW_BK)[n0 .. n0 + DW_BN), the sum over the expert's
// rows in slot order, GBK rows a stage.
__global__ void __launch_bounds__(DwCfg::THREADS, 1)
gmm_dw_wgmma(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_dy,
             const __grid_constant__ CUtensorMap map_dw,
             const bf16* __restrict__ x, const bf16* __restrict__ dy,
             const int* __restrict__ perm, const int* __restrict__ off,
             const int* __restrict__ toff, const int4* __restrict__ info,
             int K, int N, int E, int bm, int after_dx) {
  using C = DwCfg;
  unsigned char* ring = bwd_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::BARS);
  uint64_t* empty = full + BWD_ST;
  uint16_t* order = reinterpret_cast<uint16_t*>(ring + C::TAIL);
  const DwWork wk = {(int)cluster_rank(), (int)gridDim.x / DW_CK,
                     (int)blockIdx.x / DW_CK,
                     ((K + DW_BK - 1) / DW_BK + DW_CK - 1) / DW_CK,
                     (N + DW_BN - 1) / DW_BN};
  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_ST; ++s) {
      // the producer's expect_tx (a gather's cp.async's add their own)
      mbar_init(&full[s], 1);
      // an arrival a consumer warpgroup of the cluster
      mbar_init(&empty[s], C::NWG * DW_CK);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Launched as a programmatic dependent.  Right after dX (after_dx), it
  // starts once every dX block has passed its own wait for the grids
  // before, so what dW reads (x, dY, the plan) is written by then: dW runs
  // beside dX's last tiles and waits for dX only before it ends, so that
  // it ends after dX.  Else it waits for the grid before here.
  if (!after_dx) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the experts by rows, most first, ties by expert (the epilogue buffers
  // hold the counts meanwhile): every block of the launch the same order
  int* cnt = reinterpret_cast<int*>(ring + C::EPI);
  for (int e = threadIdx.x; e < E; e += C::THREADS)
    cnt[e] = off[e + 1] - off[e];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += C::THREADS) {
    const int n = cnt[e];
    int r = 0;
    for (int f = 0; f < E; ++f) r += cnt[f] > n || (cnt[f] == n && f < e);
    order[r] = (uint16_t)e;
  }
  // every block's barriers are initialised and its order written before
  // any block of the cluster arrives on them or loads into its stages
  cluster_arrive();
  cluster_wait();

  int it = 0;                           // stages through the ring so far
  DwItem t;
  if (threadIdx.x < C::CONSUMERS) {
    const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
    unsigned char* bufs = ring + C::EPI + wg * 2 * EPI_BUF;
    for (int w = 0; dw_item(wk, w, order, off, E, t); ++w) {
      const int nk = (t.s1 - t.s0 + GBK - 1) / GBK;
      // whether every tile of the expert's is one run of x, so no stage of
      // the item is gathered (the model's sorted ids)
      const int t0 = toff[t.e], t1 = toff[t.e + 1];
      bool runs = true;
      for (int i = t0; i < t1; ++i) runs = runs && info[i].w >= 0;
      // the item's first product overwrites the accumulators (scale-d 0):
      // no other instruction writes them
      float acc[DW_BN / 2];
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % BWD_ST, rel = kt * GBK;
        unsigned char* st = ring + s * C::STAGE;
        // gathered by cp.async (its tile of the plan no run of x), or not
        const bool gathered = !runs && info[t0 + rel / bm].w < 0;
        mbar_wait(&full[s], (it / BWD_ST) & 1);
        // a partial last stage: its rows n .. GBK - 1 in every panel
        // (contiguous, the swizzle stays inside a row) are set to zero
        const int n = min(GBK, t.s1 - t.s0 - rel);
        if (n < GBK) {
          constexpr int PANELS = (DW_BK + DW_BN) / 64;
          const int per = (GBK - n) * 8;      // 16-byte pieces a panel
          for (int j = threadIdx.x; j < PANELS * per; j += C::CONSUMERS)
            *reinterpret_cast<uint4*>(st + j / per * 8192 + n * 128 +
                                      j % per * 16) = make_uint4(0, 0, 0, 0);
        }
        // the generic proxy's writes (cp.async, the zeros) before wgmma's
        // reads
        if (gathered || n < GBK) fence_proxy_async();
        if (n < GBK) named_sync(1, C::CONSUMERS);
        const unsigned char* sA = st + wg * 8192;
        const unsigned char* sB = st + C::A_BYTES;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk)
          wgmma_bf<DW_BN, 1, 1>(acc, wg_desc(sA + kk * 2048, 8192, 1024),
                                wg_desc(sB + kk * 2048, 8192, 1024),
                                kt + kk > 0);
        wg_commit();
        wg_wait<1>();
        wg_touch<DW_BN / 2>(acc);
        if (kt > 0) hand_back(&empty[(it - 1) % BWD_ST], DW_CK);
      }
      wg_wait<0>();
      wg_touch<DW_BN / 2>(acc);
      if (nk > 0) hand_back(&empty[(it - 1) % BWD_ST], DW_CK);

      // the epilogue, by TMA while the next item's stages load and run; an
      // expert with no row writes zeros
      const int k0 = t.k0 + 64 * wg;
      epilogue<DW_BN>(bufs, acc, nk > 0, [&](int p, const unsigned char* buf) {
        if (tw == 0 && k0 < K && t.n0 + 64 * p < N)
          tma_store_3d(&map_dw, buf, t.n0 + 64 * p, k0, t.e);
      });
    }
    if (tw == 0) bulk_wait();
  } else {
    // the DW_PW producer warps
    const int pt = threadIdx.x - C::CONSUMERS;
    const int lane = pt & 31, pw = pt >> 5;
    for (int w = 0; dw_item(wk, w, order, off, E, t); ++w) {
      const int nk = (t.s1 - t.s0 + GBK - 1) / GBK;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % BWD_ST, rel = kt * GBK;
        unsigned char* sA = ring + s * C::STAGE;
        unsigned char* sB = sA + C::A_BYTES;
        // the stage's tile of the plan: a run of x from its first x row,
        // by thread 0's TMA, or gathered by every producer thread.  Every
        // producer thread waits for every stage to be free, also one that
        // thread 0 alone fills, and the producers move on together: none
        // runs ahead of the barrier's phase, so its parity names the right
        // one.
        const int4 tile = info[toff[t.e] + rel / bm];
        if (it >= BWD_ST) mbar_wait(&empty[s], (it / BWD_ST - 1) & 1);
        named_sync(4, 32 * DW_PW);
        if (tile.w >= 0) {
          if (pt != 0) continue;
          const int xrow = tile.w + rel % bm;
          // a box wholly past K or N is not loaded: its rows or columns
          // of the tile are not stored
          int bytes = 0;
          for (int q = 0; q < DW_BK / 64; ++q)
            bytes += t.k0 + 64 * q < K ? 8192 : 0;
          for (int p = 0; p < DW_BN / 64; ++p)
            bytes += t.n0 + 64 * p < N ? 8192 : 0;
          mbar_expect(&full[s], bytes);
          for (int q = 0; q < DW_BK / 64; ++q)
            if (t.k0 + 64 * q < K)
              tma_load_2d(sA + q * 8192, &map_x, &full[s], t.k0 + 64 * q,
                          xrow);
          // this block's share of dY's boxes, into every block of the
          // cluster
          for (int p = wk.kr; p < DW_BN / 64; p += DW_CK)
            if (t.n0 + 64 * p < N)
              tma_load_2d_mc(sB + p * 8192, &map_dy, &full[s], t.n0 + 64 * p,
                             xrow, (1u << DW_CK) - 1);
          continue;
        }
        // gathered: row r's 16-byte chunk c at chunk c ^ (r % 8) of its
        // 128-byte row in its panel; rows past the expert and columns past
        // K or N are zeros.  Warp pw takes rows pw, pw + DW_PW, ..: a lane
        // a 16-byte chunk of dY's row (DW_BN / 8 = 32 chunks), and half a
        // warp a row pair of x (DW_BK / 8 = 16 chunks); each lane holds
        // the x rows of slots lane and lane + 32, broadcast by shuffles.
        static_assert(DW_BN / 8 == 32 && DW_BK / 8 == 16, "a lane a chunk");
        const int base = t.s0 + rel;
        const int lo = base + lane < t.s1 ? perm[base + lane] : -1;
        const int hi = base + 32 + lane < t.s1 ? perm[base + 32 + lane] : -1;
#pragma unroll 4
        for (int r = pw; r < GBK; r += DW_PW) {
          const int row = __shfl_sync(0xffffffffu, r < 32 ? lo : hi, r & 31);
          const int col = t.n0 + lane * 8;
          const bool in = row >= 0 && col < N;
          cp_async16(sB + (lane >> 3) * 8192 + r * 128 +
                         (((lane & 7) ^ (r & 7)) << 4),
                     in ? dy + (long long)row * N + col : dy, in ? 16 : 0);
        }
#pragma unroll 4
        for (int r2 = 2 * pw; r2 < GBK; r2 += 2 * DW_PW) {
          const int r = r2 + (lane >> 4), c = lane & 15;
          const int src = __shfl_sync(0xffffffffu, r2 < 32 ? lo : hi,
                                      r2 & 31);
          const int nxt = __shfl_sync(0xffffffffu, r2 < 32 ? lo : hi,
                                      (r2 + 1) & 31);
          const int row = lane < 16 ? src : nxt, col = t.k0 + c * 8;
          const bool in = row >= 0 && col < K;
          cp_async16(sA + (c >> 3) * 8192 + r * 128 +
                         (((c & 7) ^ (r & 7)) << 4),
                     in ? x + (long long)row * K + col : x, in ? 16 : 0);
        }
        // every producer's copies hold the phase open before the last
        // arrival may close it
        cp_async_arrive(&full[s]);
        named_sync(4, 32 * DW_PW);
        if (pt == 0) mbar_arrive(&full[s]);
      }
    }
  }
  // no block leaves while a block of its cluster may still arrive on its
  // barriers, nor before dX has ended
  __syncwarp();
  cluster_arrive();
  if (after_dx) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  cluster_wait();
}

// bf16 dW with K or N not a multiple of 8: block (N tile, K tile, expert)
// of 64 x 64, WBK rows of the expert a step, on wmma: A = x^T from its
// rows stored row by row (a column-major A), B = dY.
__global__ void __launch_bounds__(WNT) gmm_dw_wmma_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
    bf16* __restrict__ dw, const int* __restrict__ perm,
    const int* __restrict__ off, int K, int N) {
  __shared__ __align__(128) bf16 As[WBK * LDB];      // As[t][k]
  __shared__ __align__(128) bf16 Bs[WBK * LDB];      // Bs[t][n]
  __shared__ __align__(128) float Cs[SUB * LDC];
  __shared__ int rows[WBK];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  const int n0 = blockIdx.x * SUB, k0 = blockIdx.y * SUB, e = blockIdx.z;
  const int s0 = off[e], s1 = off[e + 1];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int t0 = s0; t0 < s1; t0 += WBK) {
    if (tid < WBK) rows[tid] = t0 + tid < s1 ? perm[t0 + tid] : -1;
    __syncthreads();
    for (int i = tid; i < WBK * SUB; i += WNT) {
      const int t = i / SUB, c = i % SUB, row = rows[t];
      const uint16_t a =
          row >= 0 && k0 + c < K ? x[(long long)row * K + k0 + c] : 0;
      const uint16_t b =
          row >= 0 && n0 + c < N ? dy[(long long)row * N + n0 + c] : 0;
      As[t * LDB + c] = *reinterpret_cast<const bf16*>(&a);
      Bs[t * LDB + c] = *reinterpret_cast<const bf16*>(&b);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[kk * LDB + wr * 32 + i * 16], LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wc * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
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
  bf16* dwe = dw + (long long)e * K * N;
  for (int i = tid; i < SUB * SUB; i += WNT) {
    const int k = k0 + i / SUB, n = n0 + i % SUB;
    if (k < K && n < N)
      dwe[(long long)k * N + n] = __float2bfloat16(Cs[i / SUB * LDC + i % SUB]);
  }
}

// f32 dW: block (N tile, K tile, expert) of 64 x 64, FBK rows of the
// expert a step, each output one chain of FMAs over the rows in order.
__global__ void __launch_bounds__(FNT) gmm_dw_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    float* __restrict__ dw, const int* __restrict__ perm,
    const int* __restrict__ off, int K, int N) {
  __shared__ float As[FBK][SUB + 4];      // As[t][k]
  __shared__ float Bs[FBK][SUB + 4];      // Bs[t][n]
  __shared__ int rows[FBK];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * SUB, k0 = blockIdx.y * SUB, e = blockIdx.z;
  const int s0 = off[e], s1 = off[e + 1];
  float acc[4][4] = {};
  for (int t0 = s0; t0 < s1; t0 += FBK) {
    if (tid < FBK) rows[tid] = t0 + tid < s1 ? perm[t0 + tid] : -1;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < FBK * SUB / FNT; ++v) {
      const int idx = tid + v * FNT;
      const int t = idx / SUB, c = idx % SUB, row = rows[t];
      As[t][c] = row >= 0 && k0 + c < K ? x[(long long)row * K + k0 + c]
                                        : 0.0f;
      Bs[t][c] = row >= 0 && n0 + c < N ? dy[(long long)row * N + n0 + c]
                                        : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < FBK; ++t) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[t][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[t][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dwe = dw + (long long)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) dwe[(long long)k * N + n] = acc[i][j];
    }
  }
}


// SMs of the current device
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// dX on gmm_dx_wgmma, as many blocks as the card holds at once and at most
// one an item; a programmatic dependent of the launch before it.  The sum
// runs over S, the output has C columns.
template <int BM, int BN>
int launch_dx_wgmma(const void* dy, const void* w, void* dx, const int* perm,
                    const int4* info, int T, int S, int C, int E, int tiles,
                    cudaStream_t s) {
  using Cf = DxCfg<BM, BN>;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        gmm_dx_wgmma<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cf::bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gmm_dx_wgmma<BM, BN>, Cf::THREADS, Cf::bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long items = (long long)tiles * ((C + BN - 1) / BN);
  const long long blocks = (long long)per_sm * sm_count();
  CUtensorMap ma, mb, mo;
  if (blocks < 1 || !gmm_map(&ma, dy, T, S, 0, BM) ||
      !gmm_map(&mb, w, C, S, E, BN) || !gmm_map(&mo, dx, T, C, 0, 64))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(items < blocks ? items : blocks));
  cfg.blockDim = dim3(Cf::THREADS);
  cfg.dynamicSmemBytes = Cf::bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gmm_dx_wgmma<BM, BN>, ma, mb, mo,
                                 static_cast<const bf16*>(dy),
                                 static_cast<bf16*>(dx), perm, info, S, C, E,
                                 tiles);
}

// dX: the sum runs over N, the output has K columns
int launch_dx(const void* dy, const void* w, void* dx, const int* perm,
              const int4* info, int T, int K, int N, int E, int dtype,
              int path, int bm, int bn, int tiles, cudaStream_t s) {
  if (path == 0) {
    if (bm == 128 && bn == 256)
      return launch_dx_wgmma<128, 256>(dy, w, dx, perm, info, T, N, K, E,
                                       tiles, s);
    if (bm == 64 && bn == 128)
      return launch_dx_wgmma<64, 128>(dy, w, dx, perm, info, T, N, K, E,
                                      tiles, s);
    return (int)cudaErrorInvalidValue;
  }
  if (bn != SUB) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + SUB - 1) / SUB, tiles);
  if (dtype == 1)
    gmm_f32_kernel<1><<<grid, FNT, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(w),
        static_cast<float*>(dx), perm, info, N, K, E);
  else
    gmm_wmma_kernel<1><<<grid, WNT, 0, s>>>(
        static_cast<const uint16_t*>(dy), static_cast<const uint16_t*>(w),
        static_cast<bf16*>(dx), perm, info, N, K, E);
  return (int)cudaGetLastError();
}

// dW on gmm_dw_wgmma in clusters of DW_CK blocks, as many clusters as the
// card holds at once and at most one an item; a programmatic dependent of
// the launch before it, gmm_dx_wgmma's where after_dx
int launch_dw_wgmma(const void* x, const void* dy, void* dw, const int* perm,
                    const int* off, const int* toff, const int4* info, int T,
                    int K, int N, int E, int bm, int after_dx,
                    cudaStream_t s) {
  if (bm % GBK) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        gmm_dw_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DwCfg::bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DW_CK;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(DwCfg::THREADS);
  cfg.dynamicSmemBytes = DwCfg::bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters the card holds at once
  static int fit = 0;
  if (fit == 0) {
    cfg.gridDim = dim3(DW_CK * sm_count());
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&fit, gmm_dw_wgmma, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long items =
      (long long)E * (((K + DW_BK - 1) / DW_BK + DW_CK - 1) / DW_CK) *
      ((N + DW_BN - 1) / DW_BN);
  CUtensorMap mx, mdy, mdw;
  if (!gmm_map(&mx, x, T, K, 0, GBK) || !gmm_map(&mdy, dy, T, N, 0, GBK) ||
      !gmm_map(&mdw, dw, K, N, E, 64))
    return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3((unsigned)(DW_CK * (items < fit ? items : fit)));
  cfg.numAttrs = 2;
  return (int)cudaLaunchKernelEx(
      &cfg, gmm_dw_wgmma, mx, mdy, mdw, static_cast<const bf16*>(x),
      static_cast<const bf16*>(dy), perm, off, toff, info, K, N, E, bm,
      after_dx);
}

// dW on the generic kernels, a block a (N tile, K tile, expert)
int launch_dw_generic(const void* x, const void* dy, void* dw,
                      const int* perm, const int* off, int K, int N, int E,
                      int dtype, cudaStream_t s) {
  const dim3 grid((N + SUB - 1) / SUB, (K + SUB - 1) / SUB, E);
  if (dtype == 1)
    gmm_dw_f32_kernel<<<grid, FNT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(dw), perm, off, K, N);
  else
    gmm_dw_wmma_kernel<<<grid, WNT, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
        static_cast<bf16*>(dw), perm, off, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// The gradients of moe_gmm_fwd's out for dy (T, N): dx (T, K), or null to
// skip it, and dw (E, K, N), or null, in x's dtype (0 = bf16, 1 = f32);
// x (T, K), w (E, K, N), dy contiguous.  perm, off, toff and info: the
// forward's plan (moe_gmm_plan) of the rows' ids, with `tiles` entries of
// info and row tiles of bm rows.  path 0 (bf16, K and N multiples of 8,
// 16-byte aligned): dX on gmm_dx_wgmma<bm, bn> with (bm, bn) = (128, 256)
// or (64, 128) over its K output columns, dW on gmm_dw_wgmma (DW_BK x
// DW_BN tiles) in clusters of DW_CK blocks along K; path 1: the generic
// kernels, 64 x 64 tiles (bn = 64).  Returns the CUDA error of the
// launches (0 on success).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, const int* perm,
                           const int* off, const int* toff, const int* info,
                           int T, int K, int N, int E, int dtype, int path,
                           int bm, int bn, int tiles, void* stream) {
  if (T < 0 || K < 0 || N < 0 || E < 1 || E > MAXE || tiles < 0 ||
      tiles > 65535 || (dtype != 0 && dtype != 1) || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  if (path == 0) {
    const uintptr_t align =
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
        reinterpret_cast<uintptr_t>(dw);
    if (dtype != 0 || K % 8 || N % 8 || align % 16)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype ? 4 : 2;
  const int4* ti = reinterpret_cast<const int4*>(info);
  // dX's bf16 kernel precedes dW's
  const bool after_dx = dx != nullptr && T > 0 && K > 0 && N > 0 && path == 0;
  if (dx != nullptr && T > 0 && K > 0) {
    const int err = N == 0
        ? (int)cudaMemsetAsync(dx, 0, (size_t)T * K * elem, s)
        : launch_dx(dy, w, dx, perm, ti, T, K, N, E, dtype, path, bm, bn,
                    tiles, s);
    if (err != 0) return err;
  }
  if (dw != nullptr && K > 0 && N > 0) {
    // with no rows every expert's sum is empty
    if (T == 0) return (int)cudaMemsetAsync(dw, 0, (size_t)E * K * N * elem, s);
    return path == 0 ? launch_dw_wgmma(x, dy, dw, perm, off, toff, ti, T, K,
                                       N, E, bm, after_dx, s)
                     : launch_dw_generic(x, dy, dw, perm, off, K, N, E, dtype,
                                         s);
  }
  return 0;
}
