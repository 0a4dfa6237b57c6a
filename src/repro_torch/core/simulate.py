"""Dataflow FIFO simulators: event-driven (default), per-cycle (reference),
and a NumPy-vectorized batch engine for floorplan sweeps.

Validates the paper's central throughput theorem (§5): pipelining every
cross-slot stream and *balancing* reconvergent paths leaves steady-state
throughput unchanged — total execution cycles grow only by the pipeline
fill/drain skew (paper Tables 4-7 report cycle deltas of ~10 out of 1e5).

Model: each task fires when every input FIFO has a visible token and every
output FIFO has space; a firing consumes/produces one token per stream.  A
stream has ``capacity`` slots and ``latency`` cycles (a written token
becomes visible to the consumer ``latency`` cycles later — the pipeline
registers; it occupies a FIFO slot from the moment it is written).  Tasks
may have an initiation interval > 1.  This is the FSM/ap_ctrl hand-shake
abstraction of the paper's RTL at the granularity that matters for
inter-task throughput.

Capacity ownership
------------------
``capacity(s) = s.depth + extra_capacity[s]`` — nothing more.  The
almost-full round-trip headroom a pipelined stream needs to sustain full
throughput (paper Fig. 10) is owned by the *pipeliner*:
``assign_pipelining`` returns it as ``extra_depth = 2 * lat`` and
``Plan.sim_extra_capacity`` exposes it for simulation.  Earlier revisions
silently added another ``2 * latency`` inside ``simulate`` on top of the
pipeliner's term, handing callers 4x headroom that masked real almost-full
stalls; use ``pipeline_headroom`` if you need the term for an ad-hoc
latency map.

Engines
-------
* ``engine="event"`` (default): a ready-heap of (earliest-fire-cycle, task)
  events derived from FIFO token-visibility times, initiation intervals and
  almost-full back-pressure.  Wall-time scales with the number of firings,
  not the number of cycles — a task with II=8 costs one event per firing
  instead of 7 idle scans, and fill/drain phases cost nothing.
* ``engine="cycle"``: the original synchronous per-cycle scan, kept as the
  reference semantics; the event engine is cross-checked against it on
  randomized graphs in the test suite.
* ``simulate_batch``: many (graph, latency, capacity, II) variants at once.
  Jobs are grouped by topology signature and *padded* to the largest
  (task, stream) shape in the batch (the canonical layout lives in
  ``repro_torch.kernels.padded_batch``), so one (V, T*, S*) array-sweep
  covers heterogeneous graphs (cross-design benchmark tables, multi-device
  sweeps) as well as the classic fixed-topology floorplan sweep.  Two
  array backends share that layout: the NumPy sweep (the bit-exact
  oracle) and the torch sweep (``repro_torch.kernels.sim_sweep``), a
  hand-written CUDA kernel on the card and its plain PyTorch version on
  the CPU, which ``backend="auto"`` picks for every batch of more than one
  job.  The event engine runs a lone job, or every job with
  ``backend="event"``.

All engines implement the exact same synchronous-firing semantics: a task
fires at cycle t iff its constraints hold on the state produced by cycles
< t, so same-cycle firings are order-independent and all four engines
agree bit-for-bit on ``cycles``/``fired``/``deadlocked``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import warnings
from collections import deque
from typing import Mapping, Sequence

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .graph import TaskGraph

import numpy as np


@dataclasses.dataclass
class StreamProfile:
    """Observed FIFO pressure of one stream (event engine, paper §6.3 knob
    guidance): how full the FIFO actually ran, so callers can size capacity
    from measured occupancy instead of the uniform ``2*latency`` headroom.

    Occupancy semantics match the engine: a token occupies a slot from the
    cycle it is pushed through the cycle it is popped (the slot becomes
    reusable one cycle after the pop)."""
    name: str
    capacity: int
    #: maximum occupancy ever reached
    peak: int
    #: time-weighted mean occupancy over the simulated horizon
    mean: float
    #: cycles spent completely full (producer-visible back-pressure)
    full_cycles: int
    #: cycles spent empty (consumer starvation)
    empty_cycles: int
    #: occupancy histogram: level -> cycles spent at that level
    hist: dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SimResult:
    cycles: int
    fired: dict[str, int]
    deadlocked: bool
    #: scheduler steps the engine executed (events processed for the event
    #: engine; cycles scanned for the per-cycle engines).
    steps: int = 0
    engine: str = "event"
    #: per-stream occupancy/stall profiles (event engine with profile=True)
    profiles: dict[str, StreamProfile] | None = None


@dataclasses.dataclass
class SimJob:
    """One simulation variant for ``simulate_batch``."""
    graph: TaskGraph
    latency: dict[str, int] | None = None
    extra_capacity: dict[str, int] | None = None
    ii: dict[str, int] | None = None


# Python-level engine invocations since the last reset: one per event/cycle
# engine run, one per vectorized array-sweep (NumPy or torch).
# Benchmark drivers read these to prove (and CI to enforce) that a suite's
# simulation phase stayed batched instead of degrading to per-job Python
# loops.  "fallback" ticks whenever ``backend="auto"`` silently degrades
# below the backend it would normally pick (no NumPy, or knobs outside the
# torch sweep's int32 range) — CI gates assert it stays zero.
_ENGINE_INVOCATIONS = _metrics.group(
    "sim.engine",
    {"event": 0, "cycle": 0, "numpy": 0, "torch": 0, "fallback": 0})


def reset_engine_counts() -> None:
    """Zero the global engine-invocation counters."""
    _ENGINE_INVOCATIONS.reset()


def engine_counts() -> dict[str, int]:
    """Snapshot of engine invocations since the last reset."""
    return dict(_ENGINE_INVOCATIONS)


#: why ``simulate_batch`` may not run in this process, or None.  The
#: search's pool workers set it (``sweep_forbidden``): they run the NumPy
#: floorplan chain only, and a worker forked from a process that uses the
#: card must never touch CUDA.
_SWEEP_FORBIDDEN: str | None = None


@contextlib.contextmanager
def sweep_forbidden(where: str):
    """Within the block, ``simulate_batch`` (every backend) raises
    ``RuntimeError`` naming ``where`` instead of running."""
    global _SWEEP_FORBIDDEN
    prev, _SWEEP_FORBIDDEN = _SWEEP_FORBIDDEN, where
    try:
        yield
    finally:
        _SWEEP_FORBIDDEN = prev


def _sweep_device(device):
    """``device`` as a ``torch.device``, checked: the array sweep runs on
    the card unless the caller asks for the CPU, and never carries on on
    the host when the card is missing."""
    if _SWEEP_FORBIDDEN is not None:
        raise RuntimeError(f"simulate_batch: not run in {_SWEEP_FORBIDDEN}")
    import torch

    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"simulate_batch: device must be cuda or cpu, "
                         f"got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "simulate_batch: no CUDA device is available; pass device='cpu' "
            "to run on the host")
    return dev


def _static_check(graph: TaskGraph, mode: str, *, firings: int,
                  latency=None, extra_capacity=None, ii=None):
    """Pre-flight ``analyze()`` run for ``simulate(check=...)``.

    Imported lazily: ``repro_torch.analysis`` imports ``repro_torch.core.graph`` (and
    thereby this module, via the package __init__), so a module-level
    import here would be circular."""
    if mode not in ("warn", "raise"):
        raise ValueError(f"check must be None, 'warn' or 'raise', "
                         f"got {mode!r}")
    from repro_torch.analysis import StaticAnalysisError, analyze
    rep = analyze(graph, latency=latency, extra_capacity=extra_capacity,
                  ii=ii, firings=firings)
    if rep.ok:
        return rep
    msg = f"static analysis of {graph.name!r} failed: {rep.error_summary()}"
    if mode == "raise":
        raise StaticAnalysisError(msg, rep)
    warnings.warn(msg, stacklevel=3)
    return rep


def pipeline_headroom(latency: Mapping[str, int]) -> dict[str, int]:
    """Almost-full round-trip FIFO headroom for a latency map (2 per register
    level, paper Fig. 10).  ``assign_pipelining`` computes this for plans;
    use this helper when simulating an ad-hoc latency assignment."""
    return {name: 2 * int(lat) for name, lat in latency.items()}


# ---------------------------------------------------------------------------
# shared model resolution
# ---------------------------------------------------------------------------

class _Model:
    """Graph + per-variant knobs resolved to plain indexed arrays."""

    def __init__(self, graph: TaskGraph, latency, extra_capacity, ii):
        latency = latency or {}
        extra_capacity = extra_capacity or {}
        ii = ii or {}
        self.graph = graph
        self.names = list(graph.tasks)
        # Control streams carry per-phase handshakes, not per-datum tokens:
        # exclude them from the steady-state token simulation.
        self.data = [s for s in graph.streams if not s.control]
        self.lat = {s.name: int(latency.get(s.name, 0)) for s in self.data}
        self.cap = {s.name: int(s.depth) + int(extra_capacity.get(s.name, 0))
                    for s in self.data}
        self.ii = {n: int(ii.get(n, 1)) for n in self.names}
        self.ins = {n: [s.name for s in graph.in_streams(n) if not s.control]
                    for n in self.names}
        self.outs = {n: [s.name for s in graph.out_streams(n) if not s.control]
                     for n in self.names}
        self.producer = {s.name: s.src for s in self.data}
        self.consumer = {s.name: s.dst for s in self.data}
        self.detached = {n: graph.tasks[n].detached for n in self.names}


# ---------------------------------------------------------------------------
# event-driven engine
# ---------------------------------------------------------------------------

def _profiles_from_logs(m: _Model, push_times: Mapping[str, list[int]],
                        pop_times: Mapping[str, list[int]],
                        cycles: int) -> dict[str, StreamProfile]:
    """Occupancy histograms from the engine's append-only push/pop logs.

    A token pushed at cycle u occupies a slot during cycles [u, pop_u]; the
    slot is visible as free again at pop_u + 1 (``qt[k] + 1`` in the engine).
    One merge-sweep per stream over the two already-sorted logs."""
    out: dict[str, StreamProfile] = {}
    horizon = max(cycles, 0)
    for s in m.data:
        name = s.name
        deltas: dict[int, int] = {}
        for t in push_times[name]:
            deltas[t] = deltas.get(t, 0) + 1
        for t in pop_times[name]:
            deltas[t + 1] = deltas.get(t + 1, 0) - 1
        hist: dict[int, int] = {}
        occ = peak = 0
        area = 0
        prev = 0
        for t in sorted(deltas):
            if t >= horizon:
                break
            if t > prev:
                span = t - prev
                hist[occ] = hist.get(occ, 0) + span
                area += occ * span
            occ += deltas[t]
            peak = max(peak, occ)
            prev = max(prev, t)
        if horizon > prev:
            span = horizon - prev
            hist[occ] = hist.get(occ, 0) + span
            area += occ * span
        cap = m.cap[name]
        out[name] = StreamProfile(
            name=name, capacity=cap, peak=peak,
            mean=area / horizon if horizon else 0.0,
            full_cycles=hist.get(cap, 0) if peak >= cap else 0,
            empty_cycles=hist.get(0, 0), hist=hist)
    return out


def _simulate_event(m: _Model, *, firings: int, max_cycles: int,
                    profile: bool = False) -> SimResult:
    _ENGINE_INVOCATIONS["event"] += 1
    names = m.names
    want = firings
    fired = {n: 0 for n in names}
    next_free = {n: 0 for n in names}
    # Append-only firing logs per stream: push/pop timestamps by token index.
    push_times: dict[str, list[int]] = {s.name: [] for s in m.data}
    pop_times: dict[str, list[int]] = {s.name: [] for s in m.data}

    def finish(res: SimResult) -> SimResult:
        if profile:
            res.profiles = _profiles_from_logs(m, push_times, pop_times,
                                               res.cycles)
        return res

    remaining = sum(1 for n in names if not m.detached[n] and want > 0)
    if remaining == 0:
        return finish(SimResult(cycles=0, fired=fired, deadlocked=False,
                                steps=0, engine="event"))

    def bound(n: str) -> int | None:
        """Earliest cycle at which task n's next firing can happen, or None
        if it is blocked on a token/pop that does not exist yet.  Once all
        constraints exist the bound is final for this firing index."""
        f = fired[n]
        if f >= want:
            return None
        t = next_free[n]
        for s in m.ins[n]:
            pt = push_times[s]
            if f >= len(pt):
                return None                       # token not produced yet
            t = max(t, pt[f] + 1 + m.lat[s])      # visibility time
        for s in m.outs[n]:
            k = f - m.cap[s]                      # pop freeing the slot
            if k >= 0:
                qt = pop_times[s]
                if k >= len(qt):
                    return None                   # consumer hasn't freed it
                t = max(t, qt[k] + 1)             # space visible next cycle
        return t

    heap: list[tuple[int, str]] = []
    pending: dict[str, int] = {}

    def schedule(n: str) -> None:
        b = bound(n)
        if b is None:
            return
        cur = pending.get(n)
        if cur is not None and cur <= b:
            return
        pending[n] = b
        heapq.heappush(heap, (b, n))

    for n in names:
        schedule(n)

    steps = 0
    end_time: int | None = None                   # last-completed fire cycle
    truncated = False
    while heap:
        t, n = heapq.heappop(heap)
        if end_time is not None and t > end_time:
            break
        if t >= max_cycles:
            truncated = True
            break
        if pending.get(n) != t:
            continue                              # stale duplicate
        del pending[n]
        b = bound(n)
        if b is None:
            continue
        if b > t:                                 # defensive; bounds final
            schedule(n)
            continue
        # fire at cycle t
        steps += 1
        for s in m.ins[n]:
            pop_times[s].append(t)
        for s in m.outs[n]:
            push_times[s].append(t)
        fired[n] += 1
        next_free[n] = t + max(m.ii[n], 1)
        if not m.detached[n] and fired[n] == want:
            remaining -= 1
            if remaining == 0:
                end_time = t                      # drain same-cycle events
        schedule(n)
        for s in m.outs[n]:
            schedule(m.consumer[s])
        for s in m.ins[n]:
            schedule(m.producer[s])

    if remaining == 0:
        return finish(SimResult(cycles=end_time + 1, fired=fired,
                                deadlocked=False, steps=steps, engine="event"))
    if truncated:
        return finish(SimResult(cycles=max_cycles, fired=fired,
                                deadlocked=True, steps=steps, engine="event"))
    # Deadlock: replicate the per-cycle engine's detection cycle — the first
    # quiet cycle with every FIFO head visible and every II window elapsed.
    # next_free >= last fire + 1 for every task that ever fired (II clamped
    # to >= 1), so its max already bounds the last firing cycle.
    t_dead = max(next_free.values())
    for s in m.data:
        pops, pushes = len(pop_times[s.name]), len(push_times[s.name])
        if pops < pushes:                          # head = oldest unpopped
            t_dead = max(t_dead,
                         push_times[s.name][pops] + 1 + m.lat[s.name])
    return finish(SimResult(cycles=min(t_dead + 1, max_cycles), fired=fired,
                            deadlocked=True, steps=steps, engine="event"))


# ---------------------------------------------------------------------------
# per-cycle reference engine (original semantics, kept for cross-checking)
# ---------------------------------------------------------------------------

def _simulate_cycle(m: _Model, *, firings: int, max_cycles: int) -> SimResult:
    _ENGINE_INVOCATIONS["cycle"] += 1
    names = m.names
    queues: dict[str, deque] = {s.name: deque() for s in m.data}
    cap, lat = m.cap, m.lat
    next_free = {n: 0 for n in names}
    fired = {n: 0 for n in names}
    want = {n: firings for n in names}

    cycle = 0
    while cycle < max_cycles:
        if all(fired[n] >= want[n] for n in names if not m.detached[n]):
            return SimResult(cycles=cycle, fired=fired, deadlocked=False,
                             steps=cycle, engine="cycle")
        progressed = False
        # evaluate firings against state at cycle start (synchronous update)
        plans = []
        for n in names:
            if fired[n] >= want[n] or next_free[n] > cycle:
                continue
            if any(not queues[s] or queues[s][0] > cycle for s in m.ins[n]):
                continue
            if any(len(queues[s]) >= cap[s] for s in m.outs[n]):
                continue
            plans.append(n)
        for n in plans:
            for s in m.ins[n]:
                queues[s].popleft()
            for s in m.outs[n]:
                queues[s].append(cycle + 1 + lat[s])
            fired[n] += 1
            next_free[n] = cycle + m.ii[n]
            progressed = True
        cycle += 1
        in_flight = (any(q and q[0] > cycle - 1 for q in queues.values())
                     or any(next_free[n] > cycle - 1 for n in names))
        # nothing fired, nothing in flight, no II wait => deadlock
        if (not progressed and not in_flight
                and not all(fired[n] >= want[n] for n in names
                            if not m.detached[n])):
            return SimResult(cycles=cycle, fired=fired, deadlocked=True,
                             steps=cycle, engine="cycle")
    return SimResult(cycles=cycle, fired=fired,
                     deadlocked=not all(fired[n] >= want[n] for n in names
                                        if not m.detached[n]),
                     steps=cycle, engine="cycle")


# ---------------------------------------------------------------------------
# public single-run API
# ---------------------------------------------------------------------------

def simulate(graph: TaskGraph, *, firings: int,
             latency: dict[str, int] | None = None,
             extra_capacity: dict[str, int] | None = None,
             ii: dict[str, int] | None = None,
             max_cycles: int | None = None,
             engine: str = "event",
             profile: bool = False,
             check: str | None = None) -> SimResult:
    """Run until every non-detached task fired ``firings`` times.

    latency[s]        — pipeline registers on stream s (default 0)
    extra_capacity[s] — added FIFO depth beyond the declared one; this is
                        the *only* capacity beyond ``Stream.depth`` (pass
                        ``assign_pipelining().extra_depth`` /
                        ``Plan.sim_extra_capacity`` / ``pipeline_headroom``
                        for the almost-full round-trip term)
    ii[t]             — initiation interval of task t (default 1)
    engine            — "event" (default, O(firings)) or "cycle" (reference)
    profile           — attach per-stream ``StreamProfile`` occupancy/stall
                        histograms to the result (event engine only; derived
                        from the push/pop logs, so near-free)
    check             — pre-flight static verification (``repro_torch.analysis``)
                        under the same knobs: ``"warn"`` emits a warning
                        per failed graph, ``"raise"`` raises
                        ``StaticAnalysisError`` (carrying the ``Report``)
                        instead of running a doomed simulation.  ``None``
                        (default) skips the analyzer entirely.
    """
    if check is not None:
        _static_check(graph, check, firings=firings, latency=latency,
                      extra_capacity=extra_capacity, ii=ii)
    max_cycles = max_cycles or firings * 64 + 10_000
    m = _Model(graph, latency, extra_capacity, ii)
    if engine == "event":
        return _simulate_event(m, firings=firings, max_cycles=max_cycles,
                               profile=profile)
    if profile:
        raise ValueError("profile=True requires engine='event'")
    if engine in ("cycle", "legacy"):
        return _simulate_cycle(m, firings=firings, max_cycles=max_cycles)
    raise ValueError(f"unknown engine {engine!r}")


# ---------------------------------------------------------------------------
# batched API
# ---------------------------------------------------------------------------

def _topology_signature(graph: TaskGraph):
    return (tuple(graph.tasks),
            tuple((t.detached,) for t in graph.tasks.values()),
            tuple((s.name, s.src, s.dst, s.depth, s.control)
                  for s in graph.streams))


#: default ``simulate_batch`` byte budget for the padded array state —
#: generous enough that every in-repo suite stays a single array-sweep
#: (the CI gate depends on that), small enough that a thousand-design
#: batch cannot OOM the host on its (V, S*, H) push-history ring.
DEFAULT_MAX_BYTES = 1 << 30


def _job_bytes_estimate(jobs: Sequence[SimJob]) -> int:
    """Upper-bound bytes of padded per-job array state.

    Dominated by the (V, S*, H) cumulative-push ring; the remaining
    (V, S*)/(V, T*) int64/bool state is folded in as a few extra columns.
    Uses raw graph task/stream counts (>= the engine's post-filter counts)
    and the batch-max latency, so the estimate never undershoots."""
    t_max = max(len(j.graph.tasks) for j in jobs)
    s_max = max(len(j.graph.streams) for j in jobs)
    h = 2 + max((max(j.latency.values(), default=0) if j.latency else 0)
                for j in jobs)
    return 8 * (s_max * (h + 6) + 5 * t_max)


def simulate_batch(jobs: Sequence[SimJob | TaskGraph], *, firings: int,
                   max_cycles: int | None = None,
                   backend: str = "auto",
                   max_bytes: int | None = DEFAULT_MAX_BYTES,
                   check: str | None = None,
                   device="cuda") -> list[SimResult]:
    """Simulate many (graph, latency, capacity, II) variants.

    ``jobs`` is a sequence of ``SimJob`` (bare ``TaskGraph``s are promoted
    to default jobs).  Jobs are grouped by topology signature; each group
    shares one set of task/stream index structures, and the groups are
    *padded* to the largest (task, stream) shape in the batch so a single
    synchronous array-sweep advances every job at once.  Padding rows are
    inert: phantom streams are attached to no task (they can never gate a
    firing) and phantom tasks are masked out of the firing rule and the
    termination/deadlock checks, so each job's results are exactly those of
    its own event simulation.

    backend — "auto" (default): the torch sweep on ``device`` whenever
              every knob fits the sweep's int32 range and no latency is
              below 0, else the NumPy
              sweep, with a warning and one ``engine_counts()["fallback"]``
              tick; a lone job runs the event engine, by design.
              "torch": force the torch sweep (``repro_torch.kernels.
              sim_sweep``: the CUDA kernel on the card, its plain version
              on the CPU; raises when the knobs overflow int32 or a
              latency is below 0).
              "numpy": force the NumPy array engine, the bit-exact oracle.
              "event": force per-job event simulation.
    max_bytes — byte budget for the padded array state (default 1 GiB,
              ``None`` = unlimited).  When the batch's padded allocation
              would exceed it, the batch is split into successive
              contiguous array-sweeps ("chunks") that each fit; results
              are identical to the unchunked run, and each chunk counts
              one ``numpy``/``torch`` engine invocation in
              ``engine_counts()`` — i.e. the counters report the chunk
              count.
    check   — pre-flight static verification per job (``repro_torch.
              analysis``), same semantics as ``simulate(check=...)``:
              ``"warn"`` or ``"raise"``; ``None`` (default) skips it.
    device  — where the torch sweep runs: ``"cuda"`` (default) or
              ``"cpu"``.  Checked on every call: with no CUDA device a
              call that did not pass ``device="cpu"`` raises
              ``RuntimeError`` instead of running on the host.

    The common cases: a fixed-topology floorplan sweep is one group (no
    padding waste); a cross-design benchmark table or a multi-device
    ``sweep_backends`` comparison is a handful of groups covered by one
    (V, T*, S*) sweep instead of V Python-level event runs.

    >>> from repro_torch.core import SimJob, TaskGraphBuilder, simulate_batch
    >>> b = TaskGraphBuilder("pc")
    >>> _ = b.stream("s", width=32, depth=2)
    >>> _ = b.invoke("P", area={}, outs=["s"])
    >>> _ = b.invoke("C", area={}, ins=["s"])
    >>> g = b.build()
    >>> plain, slow = simulate_batch(
    ...     [SimJob(g), SimJob(g, ii={"C": 2})], firings=10, device="cpu")
    >>> (plain.fired["C"], slow.fired["C"], plain.deadlocked, plain.engine)
    (10, 10, False, 'torch-padded')
    >>> slow.cycles > plain.cycles          # II=2 consumer takes longer
    True
    >>> chunked = simulate_batch([SimJob(g), SimJob(g, ii={"C": 2})],
    ...                          firings=10, max_bytes=1,   # one job/chunk
    ...                          device="cpu")
    >>> [r.cycles for r in chunked] == [plain.cycles, slow.cycles]
    True
    """
    max_cycles = max_cycles or firings * 64 + 10_000
    dev = _sweep_device(device)
    norm: list[SimJob] = [j if isinstance(j, SimJob) else SimJob(j)
                          for j in jobs]
    if not norm:
        return []
    if check is not None:
        for j in norm:
            _static_check(j.graph, check, firings=firings,
                          latency=j.latency, extra_capacity=j.extra_capacity,
                          ii=j.ii)
    if backend not in ("auto", "event", "numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    from repro_torch.kernels.sim_sweep import fits_int32
    if backend == "torch" and not fits_int32(norm, firings, max_cycles):
        raise ValueError(
            "torch backend is int32-only: firings, max_cycles and every "
            "latency/capacity/II knob must stay below 2**30, and no "
            "latency below 0 (use backend='numpy' for such values)")
    resolved = backend
    if backend == "auto":
        if len(norm) <= 1:
            resolved = "event"          # by design, not a degradation
        elif fits_int32(norm, firings, max_cycles):
            resolved = "torch"
        else:
            _ENGINE_INVOCATIONS["fallback"] += 1
            warnings.warn(
                "simulate_batch(backend='auto'): knobs exceed the torch "
                "sweep's int32 range or a latency is below 0, degrading "
                "to the NumPy backend",
                stacklevel=2)
            resolved = "numpy"
    with _trace.span("simulate.batch", backend=resolved, jobs=len(norm),
                     firings=firings):
        if resolved == "event":
            return [simulate(j.graph, firings=firings, latency=j.latency,
                             extra_capacity=j.extra_capacity, ii=j.ii,
                             max_cycles=max_cycles, engine="event")
                    for j in norm]
        if resolved == "torch":
            def sweep(part, **kw):
                return _simulate_batch_torch(part, device=dev, **kw)
        else:
            sweep = _simulate_batch_numpy
        chunk = len(norm)
        if max_bytes is not None:
            chunk = max(1, min(chunk,
                               int(max_bytes // _job_bytes_estimate(norm))))
        if chunk >= len(norm):
            return sweep(norm, firings=firings, max_cycles=max_cycles)
        out: list[SimResult] = []
        for i in range(0, len(norm), chunk):
            out.extend(sweep(norm[i:i + chunk], firings=firings,
                             max_cycles=max_cycles))
        return out


def _simulate_batch_torch(jobs: list[SimJob], *, firings: int,
                          max_cycles: int, device) -> list[SimResult]:
    """Padded ragged-batch engine on ``device`` (``repro_torch.kernels.
    sim_sweep``): the CUDA kernel for the card, its plain PyTorch version
    for the CPU.

    Same canonical padded layout as the NumPy engine — both consume
    ``repro_torch.kernels.padded_batch.build_padded_batch``.  Results are
    bit-identical to the NumPy oracle; the ``engine`` label is
    ``"torch-padded"``."""
    from repro_torch.kernels.padded_batch import build_padded_batch
    from repro_torch.kernels.sim_sweep import simulate_padded_torch

    _ENGINE_INVOCATIONS["torch"] += 1
    pb = build_padded_batch(jobs)
    cycles, dead, fired, steps = simulate_padded_torch(
        pb, firings=firings, max_cycles=max_cycles, device=device)
    return pb.unpack(cycles, dead, fired, steps, "torch-padded")


def _simulate_batch_numpy(jobs: list[SimJob], *, firings: int,
                          max_cycles: int) -> list[SimResult]:
    """Padded ragged-batch synchronous engine.

    State is (V, T*)/(V, S*) integer arrays over *all* jobs, where T*/S*
    are the maximum task/stream counts across topology groups (the
    canonical padded layout built by ``repro_torch.kernels.padded_batch``);
    token visibility uses a ring buffer of cumulative push counts (a token
    pushed at cycle u is visible at u + 1 + lat, so the consumer-visible
    token count at cycle t is the cumulative push count at cycle
    t - 1 - lat).  FIFO order plus constant per-stream latency make that
    view exact.  Per-group incidence matmuls run on contiguous row slices
    inside the one shared cycle loop; everything else is a full-batch
    array op.
    """
    _ENGINE_INVOCATIONS["numpy"] += 1
    from repro_torch.kernels.padded_batch import build_padded_batch

    pb = build_padded_batch(jobs)
    V, T, S, H = pb.V, pb.T, pb.S, pb.H
    groups = pb.groups
    lat, cap, ii = pb.lat, pb.cap, pb.ii
    task_active, counted = pb.task_active, pb.counted

    hist = np.zeros((V, S, H), dtype=np.int64)     # cum pushes at cycle slot
    pops = np.zeros((V, S), dtype=np.int64)
    pushes = np.zeros((V, S), dtype=np.int64)
    fired = np.zeros((V, T), dtype=np.int64)
    next_free = np.zeros((V, T), dtype=np.int64)

    active = np.ones(V, dtype=bool)
    out_cycles = np.full(V, max_cycles, dtype=np.int64)
    out_dead = np.zeros(V, dtype=bool)
    steps = 0

    def all_done():
        # phantom and detached tasks are vacuously done
        return ((fired >= firings) | ~counted).all(axis=1)

    for t in range(max_cycles):
        newly = active & all_done()
        if newly.any():
            out_cycles[newly] = t
            out_dead[newly] = False
            active &= ~newly
        if not active.any():
            break
        steps += 1

        if S:
            look = (t - 1 - lat) % H               # (V, S) ring slot
            vis_cnt = np.take_along_axis(hist, look[:, :, None],
                                         axis=2)[:, :, 0]
            tok_ok = vis_cnt > pops
            space_ok = (pushes - pops) < cap
        in_ok = np.zeros((V, T), dtype=bool)
        out_ok = np.zeros((V, T), dtype=bool)
        for g in groups:
            if g.S:
                in_ok[g.r0:g.r1, :g.T] = (
                    tok_ok[g.r0:g.r1, :g.S].astype(np.int64) @ g.a_in
                ) == g.indeg
                out_ok[g.r0:g.r1, :g.T] = (
                    space_ok[g.r0:g.r1, :g.S].astype(np.int64) @ g.a_out
                ) == g.outdeg
            else:
                in_ok[g.r0:g.r1, :g.T] = True
                out_ok[g.r0:g.r1, :g.T] = True

        can = (active[:, None] & task_active & (fired < firings)
               & (next_free <= t) & in_ok & out_ok)
        fired += can
        next_free = np.where(can, t + ii, next_free)
        if S:
            for g in groups:
                if g.S:
                    pops[g.r0:g.r1, :g.S] += can[g.r0:g.r1, g.cons]
                    pushes[g.r0:g.r1, :g.S] += can[g.r0:g.r1, g.prod]
            hist[:, :, t % H] = pushes

        progressed = can.any(axis=1)
        # post-update in-flight check at cycle t (matches reference engine);
        # phantom streams never hold tokens, phantom tasks never fire, so
        # the padded columns are inert here too
        if S:
            nonempty = pops < pushes
            head_hidden = nonempty & (vis_cnt <= pops)
            tok_flight = head_hidden.any(axis=1)
        else:
            tok_flight = np.zeros(V, dtype=bool)
        ii_flight = (next_free > t).any(axis=1)
        quiet = active & ~progressed & ~tok_flight & ~ii_flight
        if quiet.any():
            done = all_done()
            out_cycles[quiet] = t + 1
            out_dead[quiet] = ~done[quiet]
            active &= ~quiet
            if not active.any():
                break

    if active.any():
        out_cycles[active] = max_cycles
        out_dead[active] = ~all_done()[active]

    engine = "numpy-batch" if len(groups) == 1 else "numpy-padded"
    return pb.unpack(out_cycles, out_dead, fired, steps, engine)
