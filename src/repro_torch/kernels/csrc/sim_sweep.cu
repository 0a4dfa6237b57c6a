// The padded dataflow sweep of simulate_batch, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/sim_sweep.py, `_sweep` (:108) driven by
// `simulate_padded_jax` (:241): a jax.jit lax.while_loop (:220, jitted at
// :230) that advances every row of a padded (V, T*, S*) batch by one
// synchronous dataflow cycle per iteration, all rows in lockstep, until
// every row is done, deadlocked or at max_cycles.  Semantics are those of
// repro_torch/kernels/ref.py::sim_sweep_ref, bit for bit (and so of the
// NumPy oracle, repro_torch/core/simulate.py::_simulate_batch_numpy).
//
// What bounds it on an H100.  The work is a chain of dependent cycles: a
// cycle's firings read the state the cycle before wrote.  Throughput alone
// (the sum over rows of the row's cycles times ~16 int32 operations a
// stream and ~14 a task, over the 16.7 TOP/s of 132 SMs x 64 int32 lanes
// at 1.98 GHz) allows ~0.13 ms for the paper's 384-job batch.  But a row
// cannot leave its SM, since its cycles meet at barriers, so the time is
// the longest rows' cycles (1,318 there) times what one cycle costs on
// one SM: for a row of ~900 streams, 16 warps issuing ~100 instructions
// each between two barriers, and for a one-warp row the latency of those
// instructions in a row.  So the design spends few instructions a stream
// and cycle, and keeps each thread's loads independent of its stores.
//
// What the design does about it.
// * Rows sized to their work, in one launch.  The host
//   (repro_torch/kernels/sim_sweep.py::schedule) gives each row a group of
//   1-16 warps, the fewest in which a thread holds at most PER_THREAD of
//   the row's real streams and tasks, and packs the groups, longest rows
//   first, into blocks of WARPS warps.  A one-warp row synchronizes with
//   __syncwarp and a warp vote; a wider one with a named barrier of its
//   own (bar.red.or, id = its first warp), so rows that share a block never
//   wait for each other.
// * A thread's streams and tasks live in its registers: constants, pops,
//   pushes, fired, next_free, and the shared-memory offsets they touch.
//   The slots past the row's real streams and tasks are inert (the
//   sentinel task, a dummy ring slot), so both passes are straight-line
//   code that issues all of a thread's loads before its first store.
//   Streams and tasks beyond PER_THREAD a thread (rows of more than 1,024)
//   are kept in global scratch and loaded and stored each pass, through
//   the same code (the general path, also taken by a row whose ring lives
//   in global memory).
// * Each stream has its own ring of lat + 1 cumulative push counts, slot-
//   major in the row's ring (slot j of stream s at j * n_streams + s),
//   walked by one slot offset advanced by an add and a compare: a pass
//   reads the next slot, which holds the count pushed lat + 1 cycles ago,
//   that is the count visible now, and writes the last cycle's count over
//   the slot it read the pass before.  A latency-0 stream's count is used
//   as it is written.  The ring is private to its thread: no barrier.
// * A byte pair a task, fired this cycle and stalled: a stream that stalls
//   its consumer or producer stores 1 into its stalled byte (every writer
//   stores the same value, so no atomics and no order), and a task's one
//   16-bit store sets its fired byte and clears its stalled byte.
// * Two barriers a cycle.  Pass 1 over the thread's streams applies the
//   last cycle's firings (pops, pushes, the ring, the token in flight) and
//   then sets the stall flags of this cycle; barrier A ORs "in flight or
//   fired or II pending" (the last cycle's quiet test).  Pass 2 over the
//   tasks fires; barrier B ORs "a counted task not done" (the next cycle's
//   done test).  A cycle that is quiet never precedes one that is done (a
//   quiet cycle fires nothing), so testing quiet after done is the
//   reference's order.
// * The flags and the ring are in shared memory, sized per row from its
//   own n_streams / n_tasks and ring depth; the host moves a row's ring, or
//   its flags too, to global scratch when they exceed the row's share of
//   BLOCK_SMEM.
// Each row writes its count of active iterations; the wrapper takes the
// maximum, which is the lockstep count of the reference.  Everything is
// int32; the caller keeps every knob below 2**30 and every latency >= 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int PER_THREAD = 2;

// One job row's place in the launch, built by the host (the layout of
// sim_sweep.py::ROW).  ring / flags are offsets in ints into the block's
// shared memory when *_shared, else into the global scratch; spill is the
// scratch offset of the streams and tasks beyond PER_THREAD a thread.
struct Row {
  long long ring, flags, spill;
  int v, w0, warps, n_streams, n_tasks, depth, ring_shared, flags_shared;
};

struct Args {
  const int* lat;        // (V, S)
  const int* cap;        // (V, S)
  const int* cons;       // (V, S): consumer task column
  const int* prod;       // (V, S): producer task column
  const int* ii;         // (V, T)
  const uint8_t* flags;  // (V, T): bit 0 may fire, bit 1 counted
  const Row* rows;
  const int* warp_row;   // (blocks, WARPS): index into rows, -1 idle
  int S, T, firings, max_cycles;
  int* cycles;  // (V,)
  int* dead;    // (V,)
  int* fired;   // (V, T)
  int* steps;   // (V,): the row's active iterations
  int* scratch;
};

// A stream's registers.  cons / prod: byte offsets of the consumer's and
// producer's flag pair (byte 0 fired this cycle, byte 1 stalled) in the
// row's flags; at / first / last: byte offsets in the row's ring of the
// slot written next and of the stream's first and last slot.
struct Stream {
  int cap, cons, prod, pops, pushes, vis, at, first, last;
};
// A task's registers; flags: bit 0 may fire, bit 1 counted; pair: byte
// offset of its flag pair
struct Task {
  int fired, next_free, ii, flags, pair;
};
// The host sizes a row's global scratch and reads the work list with these
// sizes: sim_sweep.py's STREAM_INTS, TASK_INTS and ROW
static_assert(sizeof(Stream) == 9 * 4 && sizeof(Task) == 5 * 4 &&
                  sizeof(Row) == 56,
              "sim_sweep.py's STREAM_INTS, TASK_INTS and ROW");
// What pass 1 reads for a stream, all at once: the fired bytes of its
// consumer and producer, and its ring's next slot
struct Reads {
  int cons, prod, next;
};

// OR of `pred` over the row's group, a barrier with memory ordering: a
// warp's vote, or the named barrier `id` of the group's n threads
template <bool WARP>
__device__ __forceinline__ bool group_or(int id, int n, bool pred) {
  if (WARP) {
    __syncwarp();
    return __any_sync(0xffffffffu, pred);
  }
  int out;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(out)
      : "r"((int)pred), "r"(id), "r"(n)
      : "memory");
  return out;
}

// Stream s of the row at rs.  A consumer or producer column past the row's
// real tasks takes the sentinel pair n_tasks (never fires; its stall byte
// is never read).  s >= nS gives an inert stream: the sentinel pair at both
// ends, nothing ever in it, and its one ring slot at `dummy`.
__device__ __forceinline__ Stream load_stream(const Args& a, long long rs,
                                              int s, int nS, int nT,
                                              int dummy) {
  Stream x{0x7fffffff, 2 * nT, 2 * nT, 0, 0, 0, dummy, dummy, dummy};
  if (s < nS) {
    x.cap = a.cap[rs + s];
    x.cons = 2 * min(a.cons[rs + s], nT);
    x.prod = 2 * min(a.prod[rs + s], nT);
    x.at = x.first = 4 * s;
    x.last = x.first + 4 * nS * a.lat[rs + s];
  }
  return x;
}

// Task i of the row at rt; i >= nT gives an inert task on the sentinel pair
__device__ __forceinline__ Task load_task(const Args& a, long long rt, int i,
                                          int nT) {
  if (i < nT) return Task{0, 0, a.ii[rt + i], a.flags[rt + i], 2 * i};
  return Task{0, 0, 1, 0, 2 * nT};
}

// Pass 1, its reads.  The ring's next slot holds the count pushed lat + 1
// cycles ago (a latency-0 stream's one slot is rewritten first: see
// stream_pass)
__device__ __forceinline__ Reads stream_reads(const Stream& x,
                                              const uint8_t* flg,
                                              const uint8_t* ring,
                                              int stride) {
  const int next = x.at == x.last ? x.first : x.at + stride;
  return Reads{flg[x.cons], flg[x.prod],
               *reinterpret_cast<const int*>(ring + next)};
}

// Pass 1 for one stream: apply the last cycle's firings, then this cycle's
// stall flags.  Returns the last cycle's "a token written but not yet
// visible".
__device__ __forceinline__ bool stream_pass(Stream& x, const Reads& r,
                                            uint8_t* flg, uint8_t* ring,
                                            int stride) {
  const int p = x.pops + r.cons;
  const int q = x.pushes + r.prod;
  const bool flight = p < q && x.vis <= p;
  x.pops = p;
  x.pushes = q;
  *reinterpret_cast<int*>(ring + x.at) = q;
  x.vis = x.first == x.last ? q : r.next;
  x.at = x.at == x.last ? x.first : x.at + stride;
  if (x.vis <= p) flg[x.cons + 1] = 1;
  if (q - p >= x.cap) flg[x.prod + 1] = 1;
  return flight;
}

// Pass 2 for one task: the firing rule at cycle t, from its pair's stall
// byte; one store sets the fired byte and clears the stall byte
__device__ __forceinline__ void task_pass(Task& x, int pair, int t,
                                          int firings, uint8_t* flg,
                                          bool& busy, bool& not_done) {
  const bool c = (x.flags & 1) && x.fired < firings && x.next_free <= t &&
                 (pair >> 8) == 0;
  *reinterpret_cast<uint16_t*>(flg + x.pair) = c;
  if (c) {
    ++x.fired;
    x.next_free = t + x.ii;
  }
  busy |= c || x.next_free > t;  // progressed, or an II window in flight
  not_done |= (x.flags & 2) && x.fired < firings;
}

__device__ __forceinline__ int pair_of(const Task& x, const uint8_t* flg) {
  return *reinterpret_cast<const uint16_t*>(flg + x.pair);
}

// Pass 1 over a thread's first N streams: every read, then every write
template <int N>
__device__ __forceinline__ bool streams_pass(Stream* st, uint8_t* flg,
                                             uint8_t* ring, int stride) {
  Reads rd[N];
#pragma unroll
  for (int k = 0; k < N; ++k) rd[k] = stream_reads(st[k], flg, ring, stride);
  bool busy = false;
#pragma unroll
  for (int k = 0; k < N; ++k)
    busy |= stream_pass(st[k], rd[k], flg, ring, stride);
  return busy;
}

// Pass 2 over a thread's first N tasks: every read, then every write
template <int N>
__device__ __forceinline__ void tasks_pass(Task* tk, int t, int firings,
                                           uint8_t* flg, bool& busy,
                                           bool& not_done) {
  int pr[N];
#pragma unroll
  for (int k = 0; k < N; ++k) pr[k] = pair_of(tk[k], flg);
#pragma unroll
  for (int k = 0; k < N; ++k)
    task_pass(tk[k], pr[k], t, firings, flg, busy, not_done);
}

// One row to its end.  A thread's PER_THREAD streams and tasks are in its
// registers, the slots past the row's real ones inert, so the passes are
// straight-line code whose reads all go out before the first write.
// FAST: ring and flags in shared memory and every stream and task in
// registers; else each may be in global scratch, and the streams and tasks
// beyond PER_THREAD a thread are.  WARP: a one-warp row.
template <bool FAST, bool WARP>
__device__ void walk(const Args& a, const Row& r, int lt, int* smem) {
  const int v = r.v, nS = r.n_streams, nT = r.n_tasks, firings = a.firings;
  const int nthr = 32 * r.warps, bar = r.w0, stride = 4 * nS;
  const int kept = nthr * PER_THREAD;  // streams / tasks in registers
  const long long rs = (long long)v * a.S, rt = (long long)v * a.T;
  const long long ring_n = (long long)r.depth * nS + 1;  // + the dummy
  int* ring_i = (FAST || r.ring_shared ? smem : a.scratch) + r.ring;
  int* flg_i = (FAST || r.flags_shared ? smem : a.scratch) + r.flags;
  uint8_t* ring = reinterpret_cast<uint8_t*>(ring_i);
  uint8_t* flg = reinterpret_cast<uint8_t*>(flg_i);
  Stream* spill_s = reinterpret_cast<Stream*>(a.scratch + r.spill);
  Task* spill_t = reinterpret_cast<Task*>(spill_s + max(nS - kept, 0));

  for (long long i = lt; i < ring_n; i += nthr) ring_i[i] = 0;
  for (int i = lt; i < (nT + 2) / 2; i += nthr) flg_i[i] = 0;
  Stream st[PER_THREAD];
  Task tk[PER_THREAD];
  bool nd = false;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    st[k] = load_stream(a, rs, lt + k * nthr, nS, nT, 4 * (ring_n - 1));
    tk[k] = load_task(a, rt, lt + k * nthr, nT);
    nd |= (tk[k].flags & 2) && 0 < firings;
  }
  if (!FAST) {
    for (int s = lt + kept; s < nS; s += nthr)
      spill_s[s - kept] = load_stream(a, rs, s, nS, nT, 0);
    for (int i = lt + kept; i < nT; i += nthr) {
      const Task x = load_task(a, rt, i, nT);
      spill_t[i - kept] = x;
      nd |= (x.flags & 2) && 0 < firings;
    }
  }
  bool not_done = group_or<WARP>(bar, nthr, nd);

  int t = 0, steps = 0, out_cycles, out_dead;
  bool busy_tasks = false;
  for (;; ++t) {
    if (!not_done) {  // every counted task done
      out_cycles = t;
      out_dead = 0;
      break;
    }
    if (t == a.max_cycles) {  // the horizon: truncated
      out_cycles = t;
      out_dead = 1;
      break;
    }
    // pass 1: the last cycle's pops, pushes and ring; this cycle's stalls
    // (a second slot only where some thread of the row has a stream in it)
    bool busy = busy_tasks;
    static_assert(PER_THREAD == 2, "the passes take one slot or two");
    if (nS > nthr)
      busy |= streams_pass<2>(st, flg, ring, stride);
    else
      busy |= streams_pass<1>(st, flg, ring, stride);
    if (!FAST) {
      for (int s = lt + kept; s < nS; s += nthr) {
        Stream x = spill_s[s - kept];
        busy |= stream_pass(x, stream_reads(x, flg, ring, stride), flg, ring,
                            stride);
        spill_s[s - kept] = x;
      }
    }
    // barrier A: was the last cycle quiet?  Then nothing fired in it, so
    // not done: deadlocked
    if (!group_or<WARP>(bar, nthr, busy) && t > 0) {
      out_cycles = t;
      out_dead = 1;
      break;
    }
    ++steps;
    // pass 2: firing
    busy_tasks = false;
    nd = false;
    if (nT > nthr)
      tasks_pass<2>(tk, t, firings, flg, busy_tasks, nd);
    else
      tasks_pass<1>(tk, t, firings, flg, busy_tasks, nd);
    if (!FAST) {
      for (int i = lt + kept; i < nT; i += nthr) {
        Task x = spill_t[i - kept];
        task_pass(x, pair_of(x, flg), t, firings, flg, busy_tasks, nd);
        spill_t[i - kept] = x;
      }
    }
    // barrier B: the next cycle's done test
    not_done = group_or<WARP>(bar, nthr, nd);
  }

  if (lt == 0) {
    a.cycles[v] = out_cycles;
    a.dead[v] = out_dead;
    a.steps[v] = steps;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = lt + k * nthr;
    if (i < nT) a.fired[rt + i] = tk[k].fired;
  }
  if (!FAST)
    for (int i = lt + kept; i < nT; i += nthr)
      a.fired[rt + i] = spill_t[i - kept].fired;
  for (int i = nT + lt; i < a.T; i += nthr) a.fired[rt + i] = 0;
}

__global__ void __launch_bounds__(THREADS, 2) sweep_rows(Args a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int ri = a.warp_row[blockIdx.x * WARPS + warp];
  if (ri < 0) return;
  const Row r = a.rows[ri];
  const int lt = threadIdx.x - 32 * r.w0;
  const int kept = 32 * r.warps * PER_THREAD;
  const bool fast = r.ring_shared && max(r.n_streams, r.n_tasks) <= kept;
  if (r.warps == 1) {
    if (fast)
      walk<true, true>(a, r, lt, smem);
    else
      walk<false, true>(a, r, lt, smem);
  } else if (fast) {
    walk<true, false>(a, r, lt, smem);
  } else {
    walk<false, false>(a, r, lt, smem);
  }
}

}  // namespace

extern "C" int sim_sweep_fwd(const int* lat, const int* cap, const int* cons,
                             const int* prod, const int* ii,
                             const uint8_t* flags, const void* rows,
                             const int* warp_row, int blocks, int S, int T,
                             int firings, int max_cycles, int* cycles,
                             int* dead, int* fired, int* steps, int* scratch,
                             int smem, cudaStream_t stream) {
  Args a{lat,     cap,     cons,     prod,     ii,
         flags,   static_cast<const Row*>(rows), warp_row,
         S,       T,       firings,  max_cycles,
         cycles,  dead,    fired,    steps,    scratch};
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        sweep_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  sweep_rows<<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
