"""Parallel floorplan solving: fan cold ILP solves out over a process pool.

The per-point ``autobridge`` ILP solve is the dominant sequential cost of a
design-space round (the AutoBridge observation the paper builds on), and the
solves of one round are independent of each other.  ``warm_floorplan_cache``
ships each *unique-floorplan* point to a ``concurrent.futures
.ProcessPoolExecutor`` worker; the worker runs the full ``autobridge``
co-optimization against a fresh ``FloorplanCache`` (capturing every solve of
the cycle-feedback chain, infeasibility verdicts included) and returns

    (its cache, its registry delta, its trace spans, the error string)

which the parent merges back — ``FloorplanCache.merge`` for the entries,
the generic ``repro_torch.obs.metrics.merge`` for the per-process counters that
would otherwise silently read 0 in the parent, and ``trace.absorb`` for
the worker's spans (parented under the dispatching round via the trace
token the submit path forwards).  The engine then *replays* the
round in-process against the pre-warmed cache, so every floorplan lookup is
a hit and the produced candidates are **bit-identical** to a sequential run:
``floorplan()`` is deterministic, and the replay path is exactly the
``jobs=1`` code path.

``jobs=1`` never touches the pool (the exact in-process fallback); a worker
hitting ``InfeasibleError`` is a *result*, not a failure — the verdict is
cached and the replay marks the candidate failed, the pool survives.

Fault tolerance
---------------
Worker loss must cost wall time, never results.  Each dispatched point
carries a per-future deadline; a future that misses it is counted
(``timed_out``), its (possibly hung) workers are killed, and the point is
re-dispatched with exponential backoff.  A worker crash surfaces as
``BrokenProcessPool`` on every in-flight future: the executor is rebuilt
(``pool_rebuilds``) and only the *unfinished* points are re-dispatched
(``retried``) — merged results are never recomputed.  Crash attribution is
exact: workers drop a started-marker file per attempt, so only points that
were actually running when the pool broke are charged a crash; a point
charged ``crash_limit`` times (or out of timeout retries) is *poison* — it
is quarantined as a cached infeasibility verdict (``quarantined``) so the
replay sees a verdict instead of re-crashing forever.  Exceptions raised
*by the solve itself* (other than ``InfeasibleError``, handled in-worker)
still propagate: retrying can only mask a real bug.

``REPRO_POOL_CTX`` forces the multiprocessing start method (CI runs one
pool leg under ``spawn``); ``REPRO_POOL_TIMEOUT_S`` / ``REPRO_POOL_RETRIES``
override the per-future deadline and retry budget without code changes.
The ``repro_torch.search.faults`` harness injects deterministic worker crashes
and hangs through this module's worker entry point.

No worker reaches ``simulate_batch`` or initializes CUDA: workers run the
NumPy floorplan chain (``autobridge`` without its throughput check) under
``simulate.sweep_forbidden``, and a worker that finds CUDA initialized
after its solve raises.  That is what makes the default ``fork`` safe in a
process that already uses the card (``search_until_converged(jobs=N)``
scores round 1 on the card before round 2 forks its workers): the fork
copies the parent's CUDA state, which only a child that touches CUDA would
trip on.  Counterpart of ``repro.search.pool``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures.process import BrokenProcessPool
from typing import Sequence

from repro_torch.core.autobridge import (FloorplanCache, autobridge,
                                   initial_floorplan_key)
from repro_torch.core.devicegrid import SlotGrid
from repro_torch.core.graph import TaskGraph
from repro_torch.core.ilp import InfeasibleError
from repro_torch.core.simulate import sweep_forbidden

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from . import faults
from .space import SearchPoint

# Pool activity since the last reset (module-global, mirroring the
# simulator's ``engine_counts`` and autobridge's ``floorplan_counts``):
# benchmarks record these in the BENCH JSON ``sim.pool`` block and the CI
# gate checks a parallel run really dispatched and merged worker results
# (and, in the chaos job, that the fault machinery really fired).
_POOL_COUNTS = _metrics.group(
    "pool",
    {"dispatched": 0, "merged": 0, "worker_solves": 0,
     "worker_infeasible": 0, "static_skipped": 0,
     "retried": 0, "timed_out": 0, "quarantined": 0,
     "pool_rebuilds": 0})

#: default per-future deadline before a point's workers are killed and the
#: point re-dispatched (override: ``REPRO_POOL_TIMEOUT_S`` or the
#: ``timeout_s=`` parameter)
DEFAULT_TIMEOUT_S = 120.0
#: default re-dispatch budget per point for timeouts (``REPRO_POOL_RETRIES``)
DEFAULT_RETRIES = 3
#: worker crashes a single point may be implicated in before quarantine
DEFAULT_CRASH_LIMIT = 3


#: submit→merge latency per dispatched task, labelled by outcome —
#: the pool queue/dispatch timing the BENCH ``sim.pool.task_s`` block
#: and the trace summary surface.
_TASK_HIST = _metrics.histogram("pool.task_s")


def reset_pool_counts() -> None:
    """Zero the global worker-pool dispatch/merge counters."""
    _POOL_COUNTS.reset()
    _TASK_HIST.reset()


def pool_counts() -> dict[str, int]:
    """Snapshot of pool dispatches/merges/worker solves since last reset."""
    return dict(_POOL_COUNTS)


def pool_task_stats() -> dict:
    """Submit→merge latency aggregates per outcome (BENCH
    ``sim.pool.task_s``): count/sum/min/max/mean seconds for dispatched
    tasks that merged cleanly vs. came back infeasible."""
    return {"ok": _TASK_HIST.aggregate(outcome="ok"),
            "infeasible": _TASK_HIST.aggregate(outcome="infeasible")}


@dataclasses.dataclass
class PoolStats:
    """One search's worker-pool activity (``ConvergedSearch.pool``)."""
    #: worker processes requested (1 = sequential, pool never created)
    jobs: int = 1
    #: points shipped to workers (unique floorplans not already cached)
    dispatched: int = 0
    #: worker results merged back into the parent cache/counters
    merged: int = 0
    #: ILP-backed ``floorplan()`` runs performed inside workers
    worker_solves: int = 0
    #: worker runs that ended in a (cached) infeasibility verdict
    worker_infeasible: int = 0
    #: points never dispatched because the parent's static structural
    #: analysis (``autobridge(check=True)`` pre-flight) doomed the graph
    static_skipped: int = 0
    #: re-dispatches beyond a point's first (crash recovery + timeouts)
    retried: int = 0
    #: futures that missed their deadline (hung worker, killed + retried)
    timed_out: int = 0
    #: poison points recorded as cached verdicts instead of retried forever
    quarantined: int = 0
    #: executors rebuilt after a crash (``BrokenProcessPool``) or timeout
    pool_rebuilds: int = 0
    #: cumulative wall time spent inside pool fan-outs
    wall_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def absorb(self, other: "PoolStats") -> None:
        """Accumulate another fan-out's stats (per-round -> per-search)."""
        self.jobs = max(self.jobs, other.jobs)
        self.dispatched += other.dispatched
        self.merged += other.merged
        self.worker_solves += other.worker_solves
        self.worker_infeasible += other.worker_infeasible
        self.static_skipped += other.static_skipped
        self.retried += other.retried
        self.timed_out += other.timed_out
        self.quarantined += other.quarantined
        self.pool_rebuilds += other.pool_rebuilds
        self.wall_s += other.wall_s


def _point_kwargs(pt: SearchPoint) -> dict:
    """The ``autobridge`` knob kwargs of one search point."""
    return {"max_util": pt.max_util, "seed": pt.seed,
            "row_weight": pt.row_weight, "col_weight": pt.col_weight,
            "depth_scale": pt.depth_scale, "hbm_split": pt.hbm_split}


def _point_token(pt_kwargs: dict) -> str:
    """Stable per-point identity for fault decisions and crash markers."""
    return repr(tuple(sorted(pt_kwargs.items())))


#: registry entries a worker's delta must NOT carry home: fault
#: injections are counted parent-side at dispatch (the worker's own
#: counter usually dies with it — merging a survivor's would double),
#: and the parent replays the full analysis pass itself, so worker-side
#: analyzer runs are duplicate work the parent already counts.
_WORKER_DELTA_EXCLUDE = ("faults", "analysis")


def _solve_point(graph: TaskGraph, grid: SlotGrid, pt_kwargs: dict,
                 ab_kwargs: dict, token: str = "", attempt: int = 0,
                 marker_dir: str | None = None, trace_token: str = "",
                 trace_on: bool = False,
                 ) -> tuple[FloorplanCache, dict, list, str | None]:
    """Worker entry point (module-level so it pickles by reference).

    Runs the full autobridge chain for one point against a fresh cache;
    the cache captures every floorplan solve of the feedback loop, so the
    parent replay never pays an ILP.  The metrics delta is a before/after
    registry snapshot: pool workers are reused across tasks, so absolute
    counter values would double-count.  The parent folds the delta back
    with the one generic ``metrics.merge`` path and absorbs the worker's
    trace spans, whose roots are parented on ``trace_token`` (the
    dispatching process's innermost open span).

    ``marker_dir`` receives a started-marker file per attempt before any
    work (or injected fault) happens: when a crash breaks the pool, the
    parent charges the crash only to points whose marker exists — points
    still queued are re-dispatched blame-free."""
    if marker_dir:
        with open(os.path.join(marker_dir,
                               f"{_marker_name(token)}.{attempt}"), "w"):
            pass
    _trace.begin_worker(trace_token, enable_tracing=trace_on)
    faults.fire("worker_hang", token, attempt)
    faults.fire("worker_crash", token, attempt)
    before = _metrics.snapshot()
    cache = FloorplanCache()
    err = None
    with _trace.span("pool.worker_solve", attempt=attempt or None), \
            sweep_forbidden("a search pool worker"):
        try:
            autobridge(graph, grid, cache=cache, **pt_kwargs, **ab_kwargs)
        except InfeasibleError as e:
            err = str(e)
    _check_no_cuda()
    delta = _metrics.delta(before, exclude=_WORKER_DELTA_EXCLUDE)
    return cache, delta, _trace.drain(), err


def _check_no_cuda() -> None:
    """A worker leaves CUDA alone (module docstring); torch is not even
    imported unless the worker was forked from a process that had it."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("a search pool worker initialized CUDA")


def _marker_name(token: str) -> str:
    return hashlib.sha256(token.encode()).hexdigest()[:24]


def _mp_context():
    """Prefer fork (POSIX); fall back to spawn where fork is unavailable.
    ``REPRO_POOL_CTX`` forces a specific start method (the tier-1 CI
    matrix runs one pool leg under ``REPRO_POOL_CTX=spawn`` so the
    fallback path stays tested instead of vestigial).

    Fork is the only start method that works for unguarded caller scripts
    (``examples/quickstart.py``-style: no ``if __name__ == "__main__"``)
    and interactive sessions — spawn/forkserver re-run ``__main__``
    preparation in every worker.  CPython warns about forking a process
    whose other threads (torch's thread pools, the CUDA driver's once the
    card is in use) hold locks; that hazard applies to children that
    *use* those runtimes, while these workers only run the
    pure-Python/NumPy solve chain and never touch CUDA (``_solve_point``
    enforces it) — the configuration the whole tier-1 suite exercises."""
    methods = multiprocessing.get_all_start_methods()
    override = os.environ.get("REPRO_POOL_CTX")
    if override:
        if override not in methods:
            raise ValueError(
                f"REPRO_POOL_CTX={override!r} is not an available start "
                f"method (have: {', '.join(methods)})")
        return multiprocessing.get_context(override)
    return multiprocessing.get_context(
        "fork" if "fork" in methods else "spawn")


def _hard_shutdown(ex: concurrent.futures.ProcessPoolExecutor) -> None:
    """Tear an executor down even when its workers are hung or dead:
    ``shutdown(wait=True)`` alone would join a worker stuck in user code
    forever, so the worker processes are killed first.

    Killing the workers creates a second hang hazard: the call queue's
    daemon feeder thread may be blocked mid-``write`` into the (now
    reader-less) full pipe, and the executor's NON-daemon manager thread
    joins that feeder during shutdown (``call_queue.join_thread()``) —
    so a blocking ``shutdown(wait=True)`` can deadlock, and even when it
    returns early a stuck manager hangs interpreter exit.
    ``cancel_join_thread()`` makes every later ``join_thread()`` a no-op
    so nothing non-daemon can ever block on the feeder; the bounded
    reader drain then gives the pipe its capacity back so the feeder
    usually flushes its buffer and exits instead of leaking as a
    blocked (harmless, daemon) thread."""
    procs = list(getattr(ex, "_processes", {}).values())
    for proc in procs:
        try:
            proc.kill()
        except Exception:
            pass
    # reap: the executor's shutdown path only skips its sentinel puts
    # once every child reads as dead, and killed-but-unreaped ones don't
    for proc in procs:
        try:
            proc.join(5.0)
        except Exception:
            pass
    call_queue = getattr(ex, "_call_queue", None)
    if call_queue is not None:
        try:
            call_queue.cancel_join_thread()
        except Exception:
            pass
    # non-blocking shutdown first: the manager thread reaches its own
    # close point (which enqueues the feeder's exit sentinel) while the
    # drain below runs
    try:
        ex.shutdown(wait=False, cancel_futures=True)
    except Exception:
        pass
    if call_queue is not None:
        try:
            reader = call_queue._reader
            feeder = call_queue._thread
            deadline = time.monotonic() + 2.0
            while (feeder is not None and feeder.is_alive()
                   and time.monotonic() < deadline):
                # raw os.read, not recv_bytes: a worker killed mid-read
                # can leave a partial message whose garbage framing would
                # make a framed recv block; discarding raw bytes can't
                while reader.poll(0):
                    os.read(reader.fileno(), 1 << 16)
                feeder.join(0.05)
        except Exception:
            pass
    try:
        ex.shutdown(wait=True, cancel_futures=True)
    except Exception:
        pass


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


@dataclasses.dataclass
class _Task:
    """Parent-side bookkeeping for one dispatched point."""
    pt: SearchPoint
    key: tuple
    token: str
    #: times submitted so far (also the ``attempt`` the worker sees, so
    #: transient injected faults fire on attempt 0 and pass on the retry)
    dispatches: int = 0
    #: pool breaks this point was *running* during (started-marker proof)
    crashes: int = 0
    #: deadlines missed
    timeouts: int = 0
    deadline: float = 0.0
    #: ``time.monotonic()`` at the latest submit (queue+solve latency)
    submitted_at: float = 0.0


def warm_floorplan_cache(graph: TaskGraph, grid: SlotGrid,
                         points: Sequence[SearchPoint], *,
                         cache: FloorplanCache,
                         jobs: int,
                         ab_kwargs: dict | None = None,
                         timeout_s: float | None = None,
                         max_retries: int | None = None,
                         crash_limit: int | None = None,
                         backoff_s: float = 0.05) -> PoolStats:
    """Solve the given points' floorplans in parallel and merge the results
    into ``cache`` (plus this process's global counters).

    Points whose initial floorplan key is already cached are skipped — a
    prior full run cached their whole solve chain, so re-dispatching would
    only burn a worker.  With ``jobs <= 1`` or nothing to solve this is a
    no-op returning empty stats.

    Worker loss is survived, not propagated (module docstring): timeouts
    and ``BrokenProcessPool`` rebuild the executor and re-dispatch only the
    unfinished points, with exponential backoff between rebuilds; a point
    implicated in ``crash_limit`` worker crashes (or out of timeout
    retries) is quarantined as a cached infeasibility verdict."""
    ab_kwargs = {k: v for k, v in (ab_kwargs or {}).items() if k != "cache"}
    stats = PoolStats(jobs=max(jobs, 1))
    if jobs <= 1:
        return stats
    todo = [pt for pt in points
            if initial_floorplan_key(graph, grid, **_point_kwargs(pt),
                                     **ab_kwargs) not in cache]
    if not todo:
        return stats
    if ab_kwargs.get("check"):
        # Parent-side pre-flight: structural errors are knob-invariant
        # (``with_knobs`` never moves pins or changes the grid shape), so
        # one analysis stands in for every worker's — when it fails, cache
        # the identical verdict each worker would have produced and skip
        # the dispatch entirely.  Lazy import (circularity, see autobridge).
        from repro_torch.analysis import analyze
        from repro_torch.analysis.report import _ANALYSIS_COUNTS
        rep = analyze(graph, grid=grid, passes=("structure",))
        if not rep.ok:
            msg = f"static analysis: {rep.error_summary()}"
            for pt in todo:
                cache.record_infeasible(
                    initial_floorplan_key(graph, grid, **_point_kwargs(pt),
                                          **ab_kwargs), msg)
            _ANALYSIS_COUNTS["infeasible"] += len(todo)
            stats.static_skipped = len(todo)
            _POOL_COUNTS["static_skipped"] += len(todo)
            return stats
    if timeout_s is None:
        timeout_s = _env_float("REPRO_POOL_TIMEOUT_S", DEFAULT_TIMEOUT_S)
    if max_retries is None:
        max_retries = int(_env_float("REPRO_POOL_RETRIES", DEFAULT_RETRIES))
    if crash_limit is None:
        crash_limit = DEFAULT_CRASH_LIMIT
    plan = faults.active_plan()

    t0 = time.monotonic()
    _span = _trace.begin("pool.warm", jobs=jobs, points=len(todo))
    tasks = []
    for pt in todo:
        kw = _point_kwargs(pt)
        tasks.append(_Task(pt=pt, token=_point_token(kw),
                           key=initial_floorplan_key(graph, grid, **kw,
                                                     **ab_kwargs)))
    stats.dispatched = len(tasks)
    marker_dir = tempfile.mkdtemp(prefix="repro-pool-")
    ex: concurrent.futures.ProcessPoolExecutor | None = None
    pending: dict[concurrent.futures.Future, _Task] = {}

    def submit(task: _Task) -> None:
        nonlocal ex
        if ex is None:
            ex = concurrent.futures.ProcessPoolExecutor(
                max_workers=min(jobs, len(tasks)), mp_context=_mp_context())
        if plan is not None:
            # the worker's own injection counter dies with the worker;
            # take the same seeded decision here so injected-vs-observed
            # counts survive into the BENCH JSON
            for site in ("worker_crash", "worker_hang"):
                if plan.decide(site, task.token, task.dispatches):
                    faults.count_injected(site)
        fut = ex.submit(_solve_point, graph, grid, _point_kwargs(task.pt),
                        ab_kwargs, task.token, task.dispatches, marker_dir,
                        _trace.current_token(), _trace.enabled())
        if task.dispatches > 0:
            stats.retried += 1
        task.dispatches += 1
        task.submitted_at = time.monotonic()
        task.deadline = task.submitted_at + timeout_s
        pending[fut] = task

    def was_running(task: _Task) -> bool:
        marker = f"{_marker_name(task.token)}.{task.dispatches - 1}"
        return os.path.exists(os.path.join(marker_dir, marker))

    def quarantine(task: _Task, why: str) -> None:
        cache.record_infeasible(task.key, f"quarantined: {why}")
        stats.quarantined += 1

    def rebuild_pool() -> None:
        nonlocal ex
        if ex is not None:
            _hard_shutdown(ex)
            ex = None
        stats.pool_rebuilds += 1
        if backoff_s > 0:
            time.sleep(min(backoff_s * (2 ** (stats.pool_rebuilds - 1)),
                           30.0))

    try:
        for task in tasks:
            submit(task)
        while pending:
            now = time.monotonic()
            wait_s = max(0.05, min(t.deadline for t in pending.values())
                         - now)
            done, _ = concurrent.futures.wait(
                set(pending), timeout=wait_s,
                return_when=concurrent.futures.FIRST_COMPLETED)
            requeue: list[_Task] = []
            broken = False
            for fut in done:
                task = pending.pop(fut)
                try:
                    wcache, delta, wspans, err = fut.result()
                except (BrokenProcessPool,
                        concurrent.futures.BrokenExecutor,
                        concurrent.futures.CancelledError):
                    broken = True
                    requeue.append(task)
                    continue
                cache.merge(wcache)
                _metrics.merge(delta)
                _trace.absorb(wspans)
                _TASK_HIST.observe(time.monotonic() - task.submitted_at,
                                   outcome="infeasible" if err else "ok")
                stats.merged += 1
                stats.worker_solves += (delta.get("floorplan", {})
                                        .get("values", {}).get("solved", 0))
                if err is not None:
                    stats.worker_infeasible += 1
            if broken:
                # the executor is unusable: drain every in-flight future
                # and charge the break only to tasks that were provably
                # running (started marker for their current attempt)
                requeue.extend(pending.values())
                pending.clear()
                survivors = []
                for task in requeue:
                    if was_running(task):
                        task.crashes += 1
                    if task.crashes >= crash_limit:
                        quarantine(task, f"worker crashed "
                                         f"{task.crashes}x on this point")
                    else:
                        survivors.append(task)
                requeue = survivors
                rebuild_pool()
            else:
                now = time.monotonic()
                overdue = [(f, t) for f, t in pending.items()
                           if now >= t.deadline]
                if overdue:
                    stats.timed_out += len(overdue)
                    survivors = []
                    for fut, task in overdue:
                        pending.pop(fut)
                        task.timeouts += 1
                        if task.timeouts > max_retries:
                            quarantine(task, f"timed out {task.timeouts}x "
                                             f"({timeout_s:g}s each)")
                        else:
                            survivors.append(task)
                    # the hung workers must die, which takes every other
                    # in-flight future with them — re-dispatch those too,
                    # blame-free
                    survivors.extend(pending.values())
                    pending.clear()
                    requeue = survivors + requeue
                    rebuild_pool()
            for task in requeue:
                submit(task)
    finally:
        if ex is not None:
            _hard_shutdown(ex)
        shutil.rmtree(marker_dir, ignore_errors=True)
        if _span is not None:
            _span["args"].update(
                merged=stats.merged, retried=stats.retried,
                timed_out=stats.timed_out, quarantined=stats.quarantined,
                pool_rebuilds=stats.pool_rebuilds)
        _trace.end(_span)
    stats.wall_s = time.monotonic() - t0
    for field in ("dispatched", "merged", "worker_solves",
                  "worker_infeasible", "retried", "timed_out",
                  "quarantined", "pool_rebuilds"):
        _POOL_COUNTS[field] += getattr(stats, field)
    return stats
