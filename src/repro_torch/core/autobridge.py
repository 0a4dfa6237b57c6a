"""AutoBridge orchestrator: floorplan -> pipeline -> balance, with the
dependency-cycle feedback loop (paper Fig. 1 + §5.2).

``autobridge()`` is the end-to-end co-optimization entry point used by both
the FPGA reproduction and the TPU deployment:

    plan = autobridge(graph, grid)
    plan.floorplan.placement     # task -> slot
    plan.depth["stream"]         # total inserted buffering (lat + balance)

If the balancer reports a pipelined dependency cycle, the cycle's tasks are
constrained into one slot and the floorplan is re-run (at most
``max_feedback`` times), exactly mirroring the paper's behaviour on the
page-rank benchmark.

Floorplan memoization
---------------------
The partitioning ILP is the dominant per-point cost of a design-space
sweep (the AutoBridge observation the paper builds on), and converging
searches revisit knob configurations on purpose: refine rounds re-anchor
on the incumbent frontier, ``sweep_backends`` re-searches the same graph
per device grid, and depth-scale variants share a floorplan outright.
``FloorplanCache`` memoizes ``floorplan()`` results by everything the ILP
actually depends on — graph topology/areas/widths, grid shape/capacities/
boundary *weights* (pipeline depths and physical delays are irrelevant to
the partitioning objective), max-util, co-location constraints and solver
knobs — so re-landing on a solved configuration costs a dict lookup.
``floorplan_counts()`` mirrors ``simulate.engine_counts()``: global
counters benchmarks and the CI regression gate read to *prove* the
memoization actually fired instead of silently re-solving.
"""
from __future__ import annotations

import dataclasses

from .balance import BalanceResult, CycleError, balance_graph
from .devicegrid import SlotGrid
from .floorplan import Floorplan, floorplan
from .graph import TaskGraph
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .ilp import (InfeasibleError, merge_solve_counts, reset_solve_counts,
                  solve_counts)
from .pipelining import PipelineAssignment, assign_pipelining
from .simulate import SimJob, SimResult, simulate_batch

# Floorplan solves / cache hits since the last reset (module-global, like
# the simulator's engine counters): ``solved`` counts actual ILP-backed
# ``floorplan()`` runs, ``cache_hits`` counts solves a ``FloorplanCache``
# answered from memory.  ``floorplan_counts()`` adds the bipartition-solver
# invocation count from ``ilp`` so a sweep can report exactly how many ILPs
# it paid for versus how many points it evaluated.
_FP_COUNTS = _metrics.group(
    "floorplan", {"solved": 0, "cache_hits": 0, "merge_conflicts": 0})


def reset_floorplan_counts() -> None:
    """Zero the global floorplan solve/cache-hit counters (and the
    underlying bipartition-solver counter)."""
    _FP_COUNTS.reset()
    reset_solve_counts()


def floorplan_counts() -> dict[str, int]:
    """Snapshot of floorplan solves, cache hits and raw bipartition-solver
    invocations since the last reset."""
    out = dict(_FP_COUNTS)
    out["ilp_bipartitions"] = solve_counts()["bipartitions"]
    return out


def merge_floorplan_counts(delta: dict[str, int]) -> None:
    """Fold a worker process's counter deltas into this process's globals.

    The solve/cache-hit counters are module globals and therefore
    per-process: a ``floorplan()`` run inside a ``ProcessPoolExecutor``
    worker increments the *worker's* copy and the parent would silently
    read 0.  The search's worker pool snapshots
    ``floorplan_counts()`` before and after each task and ships the
    difference back; merging it here keeps ``floorplan_counts()`` —
    and every benchmark/CI gate built on it — correct regardless of
    where the solve actually ran."""
    _FP_COUNTS["solved"] += int(delta.get("solved", 0))
    _FP_COUNTS["cache_hits"] += int(delta.get("cache_hits", 0))
    _FP_COUNTS["merge_conflicts"] += int(delta.get("merge_conflicts", 0))
    merge_solve_counts(delta.get("ilp_bipartitions", 0))


def _graph_signature(graph: TaskGraph) -> tuple:
    """Everything about the graph the floorplan ILP can observe: task names,
    resource vectors and pins, plus stream endpoints and widths (stream
    depth and control flags never enter the partitioning objective)."""
    return (
        tuple((n, tuple(sorted(t.area.items())), t.pinned)
              for n, t in graph.tasks.items()),
        tuple((s.name, s.src, s.dst, float(s.width)) for s in graph.streams),
    )


def _grid_signature(grid: SlotGrid) -> tuple:
    """Everything about the grid the floorplan ILP can observe: shape,
    capacities and boundary crossing *weights*.  Pipeline depths and
    physical delays only affect pipelining and the fmax surrogate, so
    depth-scale variants of one grid share a signature (and a floorplan)."""
    return (
        grid.rows, grid.cols,
        tuple(sorted(grid.base_capacity.items())),
        tuple(sorted((slot, tuple(sorted(caps.items())))
                     for slot, caps in grid.slot_caps.items())),
        tuple(b.weight for b in grid.row_boundaries),
        tuple(b.weight for b in grid.col_boundaries),
    )


def _entry_values_equal(a: tuple[str, object], b: tuple[str, object]) -> bool:
    """Do two cache entries agree?  ``floorplan()`` is deterministic, so
    two entries under one key must: ``merge`` and the disk store count a
    disagreement (``merge_conflicts``/``conflicts``) instead of letting
    first-writer-wins hide solver nondeterminism."""
    if a[0] != b[0]:
        return False
    if a[0] == "err":
        return a[1] == b[1]
    fa, fb = a[1], b[1]
    return (fa.placement == fb.placement
            and abs(fa.cost - fb.cost) <= 1e-9 * max(1.0, abs(fb.cost)))


class FloorplanCache:
    """Memoizes ``floorplan()`` solves (and infeasibility verdicts) across
    explorer calls, refine rounds and device sweeps.

    The key covers every input the ILP depends on; on a hit the stored
    ``Floorplan`` is returned with its ``grid`` swapped for the caller's
    working grid (same weights by construction — only pipeline depths may
    differ, and those are floorplan-irrelevant).  Infeasible configurations
    are cached too, so a sweep does not re-prove infeasibility per round.

    Instances are plain dict wrappers: share one across the calls whose
    solves you want deduplicated (``search_until_converged`` and
    ``sweep_backends`` do this automatically) and drop it to invalidate.
    """

    def __init__(self) -> None:
        self._entries: dict[tuple, tuple[str, object]] = {}
        self.hits = 0
        self.misses = 0
        #: ``merge``d duplicates whose values disagreed (should stay 0:
        #: ``floorplan()`` is deterministic — nonzero means nondeterminism)
        self.merge_conflicts = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return self._lookup(key) is not None

    # Storage hooks.  Every read goes through ``_lookup`` and every write
    # through ``_put`` so a subclass can add a second storage tier — a
    # disk-backed store overrides exactly these two to fall through
    # memory -> disk -> solve and to persist new entries atomically.
    def _lookup(self, key: tuple) -> tuple[str, object] | None:
        return self._entries.get(key)

    def _put(self, key: tuple, value: tuple[str, object]) -> bool:
        """Store ``value`` unless ``key`` is already present (first writer
        wins); returns True when the entry was actually added."""
        if key in self._entries:
            return False
        self._entries[key] = value
        return True

    def stats(self) -> dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses}

    def record_infeasible(self, key: tuple, reason: str) -> None:
        """Pre-seed an infeasibility verdict under ``key`` (first writer
        wins, like ``merge``).  ``autobridge(check=True)`` and the worker
        pool use this to cache *static-analysis* verdicts so a doomed
        configuration is never re-analyzed — a later ``solve()`` or check
        under the same key raises the cached ``InfeasibleError``."""
        if self._lookup(key) is None:
            self._put(key, ("err", reason))

    def cached_error(self, key: tuple) -> str | None:
        """The cached infeasibility reason under ``key``, if any."""
        hit = self._lookup(key)
        return hit[1] if hit is not None and hit[0] == "err" else None

    def merge(self, other: "FloorplanCache") -> int:
        """Adopt ``other``'s entries (a worker's cache shipped back from a
        subprocess); returns the number of entries actually added.

        First writer wins on key conflicts, but a conflicting *value*
        under an existing key is never dropped silently: ``floorplan()``
        is deterministic, so two caches can only ever hold identical
        values under the same key — a disagreement ticks
        ``merge_conflicts`` (instance + global counter, surfaced in BENCH
        JSON and gated to 0 in CI) because it means solver nondeterminism
        corrupted the bit-identity contract.  ``hits``/``misses`` are NOT
        merged: they describe each object's own lookup history, and the
        global solve counters are merged separately via
        ``merge_floorplan_counts``."""
        added = 0
        for k, v in other._entries.items():
            cur = self._lookup(k)
            if cur is None:
                self._put(k, v)
                added += 1
            elif not _entry_values_equal(cur, v):
                self.merge_conflicts += 1
                _FP_COUNTS["merge_conflicts"] += 1
        return added

    @staticmethod
    def key(graph: TaskGraph, grid: SlotGrid, *, max_util: float,
            same_slot: list[set[str]], seed: int, exact_threshold: int,
            n_starts: int, time_limit_s: float) -> tuple:
        return (_graph_signature(graph), _grid_signature(grid),
                float(max_util),
                frozenset(frozenset(g) for g in same_slot),
                seed, exact_threshold, n_starts, float(time_limit_s))

    def solve(self, graph: TaskGraph, grid: SlotGrid, *, max_util: float,
              same_slot: list[set[str]], seed: int, exact_threshold: int,
              n_starts: int, time_limit_s: float) -> Floorplan:
        k = self.key(graph, grid, max_util=max_util, same_slot=same_slot,
                     seed=seed, exact_threshold=exact_threshold,
                     n_starts=n_starts, time_limit_s=time_limit_s)
        hit = self._lookup(k)
        if hit is not None:
            self.hits += 1
            _FP_COUNTS["cache_hits"] += 1
            kind, value = hit
            if kind == "err":
                raise InfeasibleError(value)
            return dataclasses.replace(value, grid=grid)
        self.misses += 1
        _FP_COUNTS["solved"] += 1
        with _trace.span("floorplan.ilp", tasks=len(graph.tasks)) as rec:
            try:
                fp = floorplan(graph, grid, max_util=max_util,
                               same_slot=same_slot, seed=seed,
                               exact_threshold=exact_threshold,
                               n_starts=n_starts, time_limit_s=time_limit_s)
            except InfeasibleError as err:
                if rec is not None:
                    rec["args"]["infeasible"] = True
                self._put(k, ("err", str(err)))
                raise
        self._put(k, ("ok", fp))
        return fp


def initial_floorplan_key(graph: TaskGraph, grid: SlotGrid, *,
                          max_util: float | None = None,
                          same_slot: list[set[str]] = (),
                          seed: int = 0,
                          exact_threshold: int = 22,
                          n_starts: int = 8,
                          time_limit_s: float = 6.0,
                          row_weight: float = 1.0,
                          col_weight: float = 1.0,
                          depth_scale: float = 1.0,
                          hbm_split: float = 0.5,
                          **_ignored) -> tuple:
    """The ``FloorplanCache`` key of ``autobridge``'s FIRST floorplan solve
    under these knobs (cycle-feedback rounds may add further keys, but a
    full run populates those too).  The worker pool uses this to skip
    dispatching points whose solve chain a previous run already cached.
    Defaults mirror ``autobridge``'s; unrelated kwargs are ignored so the
    explorer can forward its ``ab_kwargs`` verbatim."""
    grid = grid.with_hbm_binding(hbm_split).with_knobs(
        row_weight=row_weight, col_weight=col_weight,
        depth_scale=depth_scale)
    util = grid.max_util if max_util is None else max_util
    return FloorplanCache.key(graph, grid, max_util=util,
                              same_slot=[set(g) for g in same_slot],
                              seed=seed, exact_threshold=exact_threshold,
                              n_starts=n_starts, time_limit_s=time_limit_s)


@dataclasses.dataclass
class Plan:
    graph: TaskGraph
    floorplan: Floorplan
    pipelining: PipelineAssignment
    balancing: BalanceResult
    #: total inserted depth per stream (pipelining + balancing)
    depth: dict[str, int]
    #: width-weighted total buffering overhead
    area_overhead: float
    feedback_rounds: int
    co_located: list[set[str]]
    #: streams demoted to latency-tolerant control as a cycle-breaking last
    #: resort (empty in the common case)
    demoted_streams: list[str] = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        return {
            "tasks": self.graph.num_tasks,
            "streams": self.graph.num_streams,
            "crossing_cost": self.floorplan.cost,
            "pipelined_streams": sum(1 for v in self.depth.values() if v),
            "area_overhead": self.area_overhead,
            "feedback_rounds": self.feedback_rounds,
        }

    @property
    def sim_extra_capacity(self) -> dict[str, int]:
        """Almost-full FIFO headroom for simulating this plan: the
        round-trip term (2 per inserted register level, paper Fig. 10).
        The plan owns this term — ``simulate()`` adds no implicit
        headroom."""
        return {name: 2 * d for name, d in self.depth.items()}

    def sim_job(self) -> SimJob:
        """The pipelined+balanced design as a ``simulate_batch`` job."""
        return SimJob(self.graph, latency=dict(self.depth),
                      extra_capacity=self.sim_extra_capacity)

    def verify_throughput(self, *, firings: int = 200,
                          max_cycles: int | None = None,
                          device="cuda") -> tuple[SimResult, SimResult]:
        """Simulate the design before and after co-optimization (paper §5's
        throughput theorem): returns ``(base, optimized)``.  A correct plan
        never deadlocks and adds only fill/drain skew to the cycle count.
        ``device`` is ``simulate_batch``'s: the card unless told
        ``device="cpu"``."""
        base, opt = simulate_batch(
            [SimJob(self.graph), self.sim_job()],
            firings=firings, max_cycles=max_cycles, device=device)
        return base, opt


def autobridge(graph: TaskGraph, grid: SlotGrid, *,
               max_util: float | None = None,
               same_slot: list[set[str]] = (),
               seed: int = 0,
               exact_threshold: int = 22,
               n_starts: int = 8,
               max_feedback: int = 8,
               time_limit_s: float = 6.0,
               row_weight: float = 1.0,
               col_weight: float = 1.0,
               depth_scale: float = 1.0,
               hbm_split: float = 0.5,
               cache: FloorplanCache | None = None,
               check: bool = False) -> Plan:
    # co-optimization knobs beyond max-util (joint design-space search,
    # §6.3 generalized): realized as a scaled working grid, so the whole
    # floorplan->pipeline->balance chain sees consistent weights/depths.
    # hbm_split re-binds the device's HBM channels across the channel
    # slots (SlotGrid.with_hbm_binding) — a different binding is a
    # different grid signature, so the cache keys variants apart.
    grid = grid.with_hbm_binding(hbm_split).with_knobs(
        row_weight=row_weight, col_weight=col_weight,
        depth_scale=depth_scale)
    util = grid.max_util if max_util is None else max_util

    if check:
        # Pre-flight structural verification (repro_torch.analysis): a graph
        # with dangling streams / impossible pins can never floorplan —
        # raise (and cache) the verdict instead of burning an ILP solve.
        # Lazy import: repro_torch.analysis imports repro_torch.core, so a
        # module-level import here would be circular.
        from ..analysis import analyze
        from ..analysis.report import _ANALYSIS_COUNTS
        key = None
        if cache is not None:
            key = FloorplanCache.key(graph, grid, max_util=util,
                                     same_slot=[set(g) for g in same_slot],
                                     seed=seed,
                                     exact_threshold=exact_threshold,
                                     n_starts=n_starts,
                                     time_limit_s=time_limit_s)
            cached = cache.cached_error(key)
            if cached is not None and cached.startswith("static analysis"):
                raise InfeasibleError(cached)   # verdict cached: no re-run
        rep = analyze(graph, grid=grid, passes=("structure",))
        if not rep.ok:
            msg = f"static analysis: {rep.error_summary()}"
            _ANALYSIS_COUNTS["infeasible"] += 1
            if cache is not None:
                cache.record_infeasible(key, msg)
            raise InfeasibleError(msg)

    def _floorplan(groups: list[set[str]]) -> Floorplan:
        if cache is not None:
            return cache.solve(graph, grid, max_util=util,
                               same_slot=groups, seed=seed,
                               exact_threshold=exact_threshold,
                               n_starts=n_starts, time_limit_s=time_limit_s)
        _FP_COUNTS["solved"] += 1
        with _trace.span("floorplan.ilp", tasks=len(graph.tasks)):
            return floorplan(graph, grid, max_util=util, same_slot=groups,
                             seed=seed, exact_threshold=exact_threshold,
                             n_starts=n_starts, time_limit_s=time_limit_s)

    co_located: list[set[str]] = [set(g) for g in same_slot]
    demoted: set[str] = set()      # streams demoted to control (last resort)
    pending_cycle: set[str] | None = None
    for round_ in range(max_feedback + 1):
        try:
            fp = _floorplan(co_located)
        except InfeasibleError:
            if pending_cycle is None:
                raise
            # Co-locating the cycle made the floorplan infeasible (merged
            # group too big for any slot).  Fall back: the cycle must close
            # through a latency-tolerant handshake — demote its narrowest
            # stream to a control stream and un-merge.
            co_located = [g for g in co_located if g != pending_cycle]
            cyc_streams = [s for s in graph.streams
                           if s.src in pending_cycle and s.dst in pending_cycle
                           and not s.control]
            if not cyc_streams:
                raise
            narrowest = min(cyc_streams, key=lambda s: s.width)
            narrowest.control = True
            demoted.add(narrowest.name)
            pending_cycle = None
            continue
        pending_cycle = None
        pa = assign_pipelining(graph, fp)
        try:
            bal = balance_graph(graph, pa.lat)
        except CycleError as err:
            if round_ == max_feedback:
                raise InfeasibleError(
                    f"could not break pipelined cycle after {round_} rounds: "
                    f"{err.cycle}") from err
            # paper §5.2: constrain the cycle's vertices into the same slot
            # and re-generate the floorplan.
            cyc = set(err.cycle) & set(graph.tasks)
            new_groups: list[set[str]] = []
            for g in co_located:
                if g & cyc:
                    cyc |= g
                else:
                    new_groups.append(g)
            new_groups.append(cyc)
            co_located = new_groups
            pending_cycle = cyc
            continue
        depth = {name: pa.lat[name] + bal.balance[name] for name in pa.lat}
        width = {s.name: s.width for s in graph.streams}
        overhead = sum(d * width[n] for n, d in depth.items())
        return Plan(graph=graph, floorplan=fp, pipelining=pa, balancing=bal,
                    depth=depth, area_overhead=overhead,
                    feedback_rounds=round_, co_located=co_located,
                    demoted_streams=sorted(demoted))
    raise AssertionError("unreachable")
