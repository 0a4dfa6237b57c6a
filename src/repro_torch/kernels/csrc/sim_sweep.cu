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
// at 1.98 GHz; a few MB of inputs and outputs over 3.35 TB/s) allows tens
// of microseconds for the paper's 384-job batch.  The chain allows no
// less than the longest row's cycles (1,318 there) times one cycle's three
// block barriers and the shared-memory round trips between them, a few
// hundred clocks: ~0.2-0.4 ms.  The chain is the larger, by ~10x.
//
// What the design does about it.  Rows share nothing, so one block owns one
// row and walks all of that row's cycles, persistent, and exits when its row
// is done: no row waits for the slowest, and a block's barriers are the
// only synchronisation.  The row's state lives in shared memory: the
// cumulative-push ring (S x H), pops, pushes, capacity, latency and the
// consumer / producer columns (S each), fired, next_free, II and flags (T
// each), and the per-task counts of stalled inputs and outputs and the
// firing bits (T + 1 each).  At the paper's largest row (cnn_13x16: S =
// 905, T = 480, H = 6) that is ~57 KB, so 3 blocks fit an SM and the
// 384-row batch is one wave.  Where the ring does not fit (a long latency)
// it lives in global memory, and where the rest does not fit either, that
// too; the code is the same, through the pointers.  Per cycle:
//   1. threads over streams: the visible-token and space tests, counted
//      into the task's in_bad / out_bad by integer atomicAdd (deterministic);
//      __syncthreads_or of "some counted task is not done" doubles as the
//      barrier and ends the row when it is done;
//   2. threads over tasks: firing, fired and next_free, the II in flight;
//   3. threads over streams: pops / pushes / ring update and the token in
//      flight; __syncthreads_or of "progressed or in flight" ends the row
//      as deadlocked when it is quiet.
// Each row writes its count of active iterations; the wrapper takes the
// maximum, which is the lockstep count of the reference.  Everything is
// int32; the caller keeps every knob below 2**30.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Args {
  const int* lat;   // (V, S)
  const int* cap;   // (V, S)
  const int* cons;  // (V, S): consumer task column; T for a phantom stream
  const int* prod;  // (V, S): producer task column; T for a phantom stream
  const int* ii;    // (V, T)
  const uint8_t* flags;  // (V, T): bit 0 may fire, bit 1 counted
  const int* n_streams;  // (V,): one past the row's last real stream
  const int* n_tasks;    // (V,): one past the row's last real task
  int V, S, T, H, firings, max_cycles;
  int* cycles;  // (V,)
  int* dead;    // (V,)
  int* fired;   // (V, T)
  int* steps;   // (V,): the row's active iterations
  int* scratch;        // global state of rows whose state does not fit
  long long per_row;   // ints of scratch a row
  int state_smem;      // the per-stream / per-task state is in shared memory
  int ring_smem;       // the ring is in shared memory
};

// Ints of the per-stream and per-task state, and of the ring.
__host__ __device__ inline long long state_ints(int S, int T) {
  return 6LL * S + 7LL * T + 3;
}
__host__ __device__ inline long long ring_ints(int S, int H) {
  return (long long)S * H;
}

__device__ __forceinline__ int mod(int x, int H) {
  const int m = x % H;
  return m < 0 ? m + H : m;
}

__global__ void __launch_bounds__(THREADS) sweep_row(Args a) {
  extern __shared__ int smem[];
  const int v = blockIdx.x, tid = threadIdx.x;
  const int S = a.S, T = a.T, H = a.H, firings = a.firings;
  const int nS = a.n_streams[v], nT = a.n_tasks[v];
  const long long st_n = state_ints(S, T);
  int* glob = a.scratch + (long long)v * a.per_row;
  int* st = a.state_smem ? smem : glob;
  int* ring = a.ring_smem ? smem + (a.state_smem ? st_n : 0)
                          : glob + (a.state_smem ? 0 : st_n);
  int* pops = st;
  int* pushes = pops + S;
  int* cap = pushes + S;
  int* lat = cap + S;
  int* cons = lat + S;
  int* prod = cons + S;
  int* fired = prod + S;
  int* next_free = fired + T;
  int* ii = next_free + T;
  int* flg = ii + T;
  int* in_bad = flg + T;
  int* out_bad = in_bad + T + 1;
  int* can = out_bad + T + 1;

  const long long rs = (long long)v * S, rt = (long long)v * T;
  for (int s = tid; s < nS; s += THREADS) {
    pops[s] = 0;
    pushes[s] = 0;
    cap[s] = a.cap[rs + s];
    lat[s] = a.lat[rs + s];
    cons[s] = a.cons[rs + s];
    prod[s] = a.prod[rs + s];
  }
  for (long long i = tid; i < (long long)nS * H; i += THREADS) ring[i] = 0;
  // columns past nT are phantom: they never fire (can stays 0) and are
  // vacuously done
  for (int i = tid; i <= T; i += THREADS) {
    in_bad[i] = 0;
    out_bad[i] = 0;
    can[i] = 0;
  }
  int not_done = 0;  // this thread's counted tasks not yet done
  for (int i = tid; i < nT; i += THREADS) {
    fired[i] = 0;
    next_free[i] = 0;
    ii[i] = a.ii[rt + i];
    flg[i] = a.flags[rt + i];
    not_done |= (flg[i] & 2) && 0 < firings;
  }
  __syncthreads();

  int t = 0, steps = 0, out_cycles = a.max_cycles, out_dead = -1;
  for (; t < a.max_cycles; ++t) {
    // 1. the firing rule's stream tests against the state of cycles < t
    for (int s = tid; s < nS; s += THREADS) {
      const int vis = ring[(long long)s * H + mod(t - 1 - lat[s], H)];
      const int p = pops[s];
      if (vis <= p && cons[s] < nT) atomicAdd(&in_bad[cons[s]], 1);
      if (pushes[s] - p >= cap[s] && prod[s] < nT)
        atomicAdd(&out_bad[prod[s]], 1);
    }
    if (!__syncthreads_or(not_done)) {  // every counted task done
      out_cycles = t;
      out_dead = 0;
      break;
    }
    ++steps;
    // 2. firing
    int busy = 0;
    not_done = 0;
    for (int i = tid; i < nT; i += THREADS) {
      int f = fired[i], nf = next_free[i];
      const int fl = flg[i];
      const int c = (fl & 1) && f < firings && nf <= t && in_bad[i] == 0 &&
                    out_bad[i] == 0;
      in_bad[i] = 0;
      out_bad[i] = 0;
      can[i] = c;
      if (c) {
        fired[i] = ++f;
        next_free[i] = nf = t + ii[i];
      }
      busy |= c | (nf > t);  // progressed, or an II window in flight
      not_done |= (fl & 2) && f < firings;
    }
    __syncthreads();
    // 3. pops, pushes and the ring; a token written but not yet visible
    const int slot = mod(t, H);
    for (int s = tid; s < nS; s += THREADS) {
      int* row = ring + (long long)s * H;
      const int vis = row[mod(t - 1 - lat[s], H)];
      const int p = pops[s] + can[cons[s]];
      const int q = pushes[s] + can[prod[s]];
      pops[s] = p;
      pushes[s] = q;
      row[slot] = q;
      busy |= p < q && vis <= p;
    }
    if (!__syncthreads_or(busy)) {  // quiet: nothing fired, so not done
      out_cycles = t + 1;
      out_dead = 1;
      break;
    }
  }
  // at the horizon: truncated, or done exactly there
  if (out_dead < 0) out_dead = __syncthreads_or(not_done) ? 1 : 0;
  if (tid == 0) {
    a.cycles[v] = out_cycles;
    a.dead[v] = out_dead;
    a.steps[v] = steps;
  }
  for (int i = tid; i < T; i += THREADS) a.fired[rt + i] = i < nT ? fired[i] : 0;
}

// Where a row's state goes, from the card's shared memory a block may use.
int place(int S, int T, int H, int* state_smem, int* ring_smem,
          long long* per_row, size_t* smem_bytes) {
  int dev, limit;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long st = 4 * state_ints(S, T), rg = 4 * ring_ints(S, H);
  *state_smem = st <= limit;
  *ring_smem = *state_smem && st + rg <= limit;
  *smem_bytes = (*state_smem ? st : 0) + (*ring_smem ? rg : 0);
  *per_row = (*state_smem ? 0 : st / 4) + (*ring_smem ? 0 : rg / 4);
  return 0;
}

}  // namespace

// Ints of global scratch each row needs (0 when its state fits in shared
// memory), or minus a CUDA error.
extern "C" long long sim_sweep_scratch(int S, int T, int H) {
  int state_smem, ring_smem;
  long long per_row;
  size_t smem;
  const int err = place(S, T, H, &state_smem, &ring_smem, &per_row, &smem);
  return err ? -(long long)err : per_row;
}

extern "C" int sim_sweep_fwd(const int* lat, const int* cap, const int* cons,
                             const int* prod, const int* ii,
                             const uint8_t* flags, const int* n_streams,
                             const int* n_tasks, int V, int S, int T, int H,
                             int firings, int max_cycles, int* cycles,
                             int* dead, int* fired, int* steps, int* scratch,
                             long long per_row, cudaStream_t stream) {
  Args a{lat, cap, cons, prod, ii, flags, n_streams, n_tasks, V, S, T, H,
         firings, max_cycles, cycles, dead, fired, steps, scratch, per_row,
         0, 0};
  long long want;
  size_t smem;
  int err = place(S, T, H, &a.state_smem, &a.ring_smem, &want, &smem);
  if (err) return err;
  if (want != per_row) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        sweep_row, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  sweep_row<<<V, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
