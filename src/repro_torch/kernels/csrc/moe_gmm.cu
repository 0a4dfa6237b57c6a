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
// no backward kernel, and trains through the gradient of its ref): dX on
// these kernels with w read transposed, dW a block a (K tile, N tile,
// expert) that walks the expert's rows of the plan in order.
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
// columns, 8 KB each, swizzled (w read as the MN-major B), or for the
// transposed product (KB, dX's w^T) BN rows of 64 K-columns, as A is.
// Stages start 1024-byte aligned.  The epilogue stages the bf16 tile in
// the ring, rows LDC apart.
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
template <int BM, int BN, int ST, int KB>
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
    for (int kk = 0; kk < GBK / 16; ++kk) {
      if constexpr (KB)
        wgmma_bf<BN, 0, 0>(acc, wg_desc(sA + kk * 32, 16, 1024),
                           wg_desc(sB + kk * 32, 16, 1024), 1);
      else
        wgmma_bf<BN, 0, 1>(acc, wg_desc(sA + kk * 32, 16, 1024),
                           wg_desc(sB + kk * 2048, 8192, 1024), 1);
    }
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
// It writes its bf16 tile of out over the whole of K; tiles of bucket E
// (ids out of range) write zeros.  KB 0: out = x @ w[e], w (E, K, N);
// KB 1: out = x @ w[e]^T, w (E, N, K) read K-major (the backward's dX,
// x = dY).
template <int BM, int BN, int ST, int KB>
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
    consume<BM, BN, ST, KB>(ring, full, empty, rows, tile.z, run, nk, n0, N,
                            out);
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
      if constexpr (KB)
        tma_load_3d(sB, &map_w, &full[s], kk, n0, e);
      else
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
// stream (gmm_wgmma waits for it).  K is the sum's length, N the output's
// width: for KB, w is (E, N, K), read in boxes of BN rows.
template <int BM, int BN, int ST, int KB>
int launch_wgmma(const void* x, const void* w, void* out, const int* perm,
                 const int4* info, int T, int K, int N, int E, int tiles,
                 cudaStream_t s) {
  using C = GmmCfg<BM, BN, ST>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        gmm_wgmma<BM, BN, ST, KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap mx, mw;
  const bool mapped = KB ? gmm_map(&mw, w, N, K, E, BN)
                         : gmm_map(&mw, w, K, N, E, GBK);
  if (!gmm_map(&mx, x, T, K, 0, BM) || !mapped)
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
      &cfg, gmm_wgmma<BM, BN, ST, KB>, mx, mw, static_cast<const bf16*>(x),
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
      return launch_wgmma<128, 256, 4, 0>(x, w, out, perm, ti, T, K, N, E,
                                          tiles, s);
    if (bm == 64 && bn == 128)
      return launch_wgmma<64, 128, 4, 0>(x, w, out, perm, ti, T, K, N, E,
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
// - dX is the forward's product with w transposed, on the forward's
//   kernels, tiles and grid with K and N swapped: in bf16 gmm_wgmma<..,
//   1>, whose B is w[e] read K-major (contiguous along the sum, wgmma's
//   default major) through a second TMA map over (E, K, N) with its box
//   along N; the generic kernels read w[e]'s tile along the sum.
// - dW is grouped along its sum: a block owns one (K tile, N tile,
//   expert) and walks that expert's rows, slots off[e] to off[e + 1] of
//   the plan, in increasing order, GBK rows a stage; an expert with no
//   row writes zeros.  In bf16 (gmm_dw_wgmma) two consumer warpgroups run
//   wgmma with A = x^T, MN-major from shared memory (the transposed A that
//   16-bit types allow), and B = dY, MN-major as in the forward; four
//   producer warps gather each stage's x and dY rows through perm by
//   cp.async (zeros past the expert's rows and the matrices' edges) into
//   panels of 64 rows x 128 bytes in the 128-byte swizzle.  f32 and odd K
//   or N take 64 x 64 tiles on the FMA pipes or wmma.
//
// What bounds it on an H100: at granite-moe's training shapes (32,800
// routed rows, K 1536, N 512, E 40, bf16) each of dX and dW is 51.6
// GFLOP (0.052 ms at 989 TFLOP/s) against ~197 MB read and written once
// (0.059 ms at 3.35 TB/s): bytes, narrowly.  dW reads each dY row once a
// K tile and each x row once an N tile, mostly from L2.

namespace {

constexpr int DW_BK = 128;          // K rows of a bf16 dW tile (2 warpgroups)
constexpr int DW_BN = 256;          // N columns of a bf16 dW tile
constexpr int DW_PW = 4;            // producer warps of a dW block

// Stage s of the dW ring: GBK rows of x (DW_BK / 64 panels of 64 rows x
// 64 K-columns), then the same rows of dY (BN / 64 panels of 64 columns),
// 8 KB a panel, each row 128 bytes, swizzled.
template <int BN, int ST>
struct DwCfg {
  static constexpr int NWG = DW_BK / 64;
  static constexpr int CONSUMERS = NWG * 128;
  static constexpr int THREADS = CONSUMERS + 32 * DW_PW;  // + the producers
  static constexpr int A_BYTES = GBK * DW_BK * 2;
  static constexpr int B_BYTES = GBK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDC = BN + 8;
  static constexpr size_t smem = 1024 + (size_t)ST * STAGE;
  static_assert(DW_BK * LDC * 2 <= ST * STAGE, "epilogue tile fits the ring");
  static_assert(smem <= kMaxSmem, "ring fits shared memory");
};

// Block (N tile, K tile, expert): dW[e][k0 .. k0 + DW_BK)[n0 .. n0 + BN),
// the sum over the expert's rows in slot order, GBK rows a stage.
template <int BN, int ST>
__global__ void __launch_bounds__(DwCfg<BN, ST>::THREADS, 1)
gmm_dw_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ dy,
             bf16* __restrict__ dw, const int* __restrict__ perm,
             const int* __restrict__ off, int K, int N) {
  using C = DwCfg<BN, ST>;
  extern __shared__ __align__(16) unsigned char gsm[];
  __shared__ uint64_t full[ST], empty[ST];
  unsigned char* ring = gsm + ((1024 - (smem_u32(gsm) & 1023)) & 1023);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * DW_BK, e = blockIdx.z;
  const int s0 = off[e], s1 = off[e + 1];
  const int nk = (s1 - s0 + GBK - 1) / GBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      // one cp.async arrival a producer thread
      mbar_init(&full[s], 32 * DW_PW);
      mbar_init(&empty[s], C::NWG);    // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < C::CONSUMERS) {
    const int wg = threadIdx.x / 128;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    wg_touch<BN / 2>(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      mbar_wait(&full[s], (kt / ST) & 1);
      fence_proxy_async();
      const unsigned char* sA = ring + s * C::STAGE + wg * 8192;
      const unsigned char* sB = ring + s * C::STAGE + C::A_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < GBK / 16; ++kk)
        wgmma_bf<BN, 1, 1>(acc, wg_desc(sA + kk * 2048, 8192, 1024),
                           wg_desc(sB + kk * 2048, 8192, 1024), 1);
      wg_commit();
      wg_wait<1>();
      wg_touch<BN / 2>(acc);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt - 1) % ST]);
    }
    wg_wait<0>();
    wg_touch<BN / 2>(acc);
    // this thread's K rows rbase and rbase + 8 of the tile, columns
    // 8 j + 2 tq (+1): stage the bf16 tile in the ring, then write it in
    // 16-byte row pieces
    const int lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int rbase = wg * 64 + (threadIdx.x / 32 % 4) * 16 + gq;
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
    bf16* dwe = dw + (long long)e * K * N;
    for (int i = threadIdx.x; i < DW_BK * BN / 8; i += C::CONSUMERS) {
      const int r = i / (BN / 8), c = i % (BN / 8) * 8;
      const int k = k0 + r, n = n0 + c;
      if (k < K && n < N)
        *reinterpret_cast<uint4*>(dwe + (long long)k * N + n) =
            *reinterpret_cast<const uint4*>(sC + r * C::LDC + c);
    }
    return;
  }
  // the DW_PW producer warps: stage kt holds the expert's slots s0 + kt
  // GBK .., row r's 16-byte chunk c at chunk c ^ (r % 8) of its 128-byte
  // row in its panel; rows past the expert and columns past K or N are
  // zeros.  Warp pw takes rows pw, pw + DW_PW, ..: a lane a 16-byte chunk
  // of dY's row (BN / 8 = 32 chunks), and half a warp a row pair of x
  // (DW_BK / 8 = 16 chunks); each lane holds the x rows of slots lane and
  // lane + 32, broadcast by shuffles.
  static_assert(BN / 8 == 32 && DW_BK / 8 == 16, "a lane a chunk");
  const int lane = threadIdx.x & 31;
  const int pw = (threadIdx.x - C::CONSUMERS) >> 5;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    unsigned char* sA = ring + s * C::STAGE;
    unsigned char* sB = sA + C::A_BYTES;
    if (kt >= ST) mbar_wait(&empty[s], (kt / ST - 1) & 1);
    const int base = s0 + kt * GBK;
    const int lo = base + lane < s1 ? perm[base + lane] : -1;
    const int hi = base + 32 + lane < s1 ? perm[base + 32 + lane] : -1;
#pragma unroll 4
    for (int r = pw; r < GBK; r += DW_PW) {
      const int row = __shfl_sync(0xffffffffu, r < 32 ? lo : hi, r & 31);
      const int col = n0 + lane * 8;
      const bool in = row >= 0 && col < N;
      cp_async16(sB + (lane >> 3) * 8192 + r * 128 +
                     (((lane & 7) ^ (r & 7)) << 4),
                 in ? dy + (long long)row * N + col : dy, in ? 16 : 0);
    }
#pragma unroll 4
    for (int r2 = 2 * pw; r2 < GBK; r2 += 2 * DW_PW) {
      const int r = r2 + (lane >> 4), c = lane & 15;
      const int src = __shfl_sync(0xffffffffu, r2 < 32 ? lo : hi, r2 & 31);
      const int nxt = __shfl_sync(0xffffffffu, r2 < 32 ? lo : hi,
                                  (r2 + 1) & 31);
      const int row = lane < 16 ? src : nxt, col = k0 + c * 8;
      const bool in = row >= 0 && col < K;
      cp_async16(sA + (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                 in ? x + (long long)row * K + col : x, in ? 16 : 0);
    }
    asm volatile(
        "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
            smem_u32(&full[s]))
        : "memory");
  }
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

// dX by the forward's kernels with w transposed: the sum runs over N, the
// output has K columns
int launch_dx(const void* dy, const void* w, void* dx, const int* perm,
              const int4* info, int T, int K, int N, int E, int dtype,
              int path, int bm, int bn, int tiles, cudaStream_t s) {
  if (path == 0) {
    if (bm == 128 && bn == 256)
      return launch_wgmma<128, 256, 4, 1>(dy, w, dx, perm, info, T, N, K, E,
                                          tiles, s);
    if (bm == 64 && bn == 128)
      return launch_wgmma<64, 128, 4, 1>(dy, w, dx, perm, info, T, N, K, E,
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

// dW, a block a (N tile, K tile, expert); launched as a programmatic
// dependent on the wgmma path, as the products are
int launch_dw(const void* x, const void* dy, void* dw, const int* perm,
              const int* off, int K, int N, int E, int dtype, int path,
              cudaStream_t s) {
  if (path == 0) {
    using C = DwCfg<DW_BN, 4>;
    static bool configured = false;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          gmm_dw_wgmma<DW_BN, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)C::smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((N + DW_BN - 1) / DW_BN, (K + DW_BK - 1) / DW_BK, E);
    cfg.blockDim = dim3(C::THREADS);
    cfg.dynamicSmemBytes = C::smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(
        &cfg, gmm_dw_wgmma<DW_BN, 4>, static_cast<const bf16*>(x),
        static_cast<const bf16*>(dy), static_cast<bf16*>(dw), perm, off, K,
        N);
  }
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
// x (T, K), w (E, K, N), dy contiguous.  perm, off and info: the forward's
// plan (moe_gmm_plan) of the rows' ids, with `tiles` entries of info and
// row tiles of bm rows.  path 0 (bf16, K and N multiples of 8, 16-byte
// aligned): dX on gmm_wgmma<bm, bn, 4, 1> with (bm, bn) = (128, 256) or
// (64, 128) over its K output columns, dW on gmm_dw_wgmma (DW_BK x DW_BN
// tiles); path 1: the generic kernels, 64 x 64 tiles (bn = 64).  Returns
// the CUDA error of the launches (0 on success).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, const int* perm,
                           const int* off, const int* info, int T, int K,
                           int N, int E, int dtype, int path, int bm, int bn,
                           int tiles, void* stream) {
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
  if (dx != nullptr && T > 0 && K > 0) {
    const int err = N == 0
        ? (int)cudaMemsetAsync(dx, 0, (size_t)T * K * elem, s)
        : launch_dx(dy, w, dx, perm, reinterpret_cast<const int4*>(info), T,
                    K, N, E, dtype, path, bm, bn, tiles, s);
    if (err != 0) return err;
  }
  if (dw != nullptr && K > 0 && N > 0) {
    // with no rows every expert's sum is empty
    if (T == 0) return (int)cudaMemsetAsync(dw, 0, (size_t)E * K * N * elem, s);
    return launch_dw(x, dy, dw, perm, off, K, N, E, dtype, path, s);
  }
  return 0;
}
