"""Batched design-space search over co-optimization knobs (paper §6.3++).

The paper's multi-floorplan methodology "implements all candidates in
parallel and keeps the best", sweeping the per-slot max-utilization knob.
``repro_torch.search`` generalizes that single axis into the *joint* space
of ``repro_torch.search.space`` (seed x max_util x boundary weights x depth
scale) and runs the floorplan -> pipeline -> balance co-optimization per
point, scores every feasible candidate with the physical model, checks all
candidates' throughput in a handful of ``simulate_batch`` calls (the
candidates share the design's topology, so hundreds of variants vectorize
into one launch of the ``sim_sweep`` kernel on the card), and prunes the
result to the Pareto frontier over (fmax, area overhead, simulated cycles).

Counterpart of ``repro.search.engine``.  Every function that reaches
``simulate_batch`` takes ``device=`` (default ``"cuda"``), checks it before
any other work and passes it on: without a card, a call that did not pass
``device="cpu"`` raises ``RuntimeError`` instead of running on the host.
The simulator backends are ``simulate_batch``'s: ``"auto"``, ``"torch"``
(the sweep kernel), ``"numpy"`` (the bit-exact oracle) and ``"event"``.
The host-side parts (the ILP floorplans, pipelining, balancing, the
physical model, the surrogate's least squares) are NumPy, as in the
reference, so their results are the reference's bit for bit.

Two structural facts keep the search cheap:

  * the floorplan ILP is invariant to ``depth_scale`` (register depth never
    appears in the partitioning objective), so depth variants of one
    (seed, util, weights) cell reuse the expensive floorplan and only re-run
    pipelining + balancing;
  * throughput evaluation is batched: one ``simulate_batch`` call scores the
    shared unpipelined baseline plus every feasible candidate.

Two execution engines scale the remaining cost:

  * ``jobs=N`` fans each round's cold ILP floorplan solves out over a
    ``ProcessPoolExecutor`` (``repro_torch.search.pool``): workers solve into
    private ``FloorplanCache``s that are merged back (entries + counter
    deltas) and the round replays in-process against the warm cache —
    bit-identical candidates to ``jobs=1``, minus the sequential ILP wall
    time.  ``jobs=1`` is the exact in-process path, no pool involved.
  * ``proposer="surrogate"`` replaces the uniform round proposals of the
    converging search with response-surface-guided ones
    (``repro_torch.search.surrogate``): a quadratic ridge model fit to the
    already-scored points ranks an oversampled candidate pool by predicted
    hypervolume improvement, falling back to the uniform draws whenever
    the fit is underdetermined.

With ``fifo_sizing=True`` frontier candidates are additionally profiled by
the event engine (per-stream occupancy histograms from the push/pop logs)
and their FIFO headroom re-sized to the *observed* peak occupancy instead
of the uniform ``2*latency`` round-trip term — trimming to the observed
peak provably preserves the simulated schedule, so the verification batch
must reproduce the same cycle count.  The reclaimed bits are then credited
back into the fmax surrogate: ``sized_report`` scores the design with its
real (smaller) buffering footprint charged into slot utilization.

Deferred scoring and multi-device sweeps: ``prepare_design_space`` returns
a ``DeferredSearch`` whose simulation jobs a caller can pool across many
searches; ``sweep_backends`` uses this to compare one design across several
device grids (U250/U280/TPU-pod shapes) with ALL grids' candidates scored
in a single ``simulate_batch`` call — the padded ragged-batch backend
vectorizes across the grids' heterogeneous candidate sets.

``explore_floorplans`` remains as a thin single-axis compatibility wrapper,
and ``SearchSpace.refine`` zooms random sampling into the numeric
neighborhood of a Pareto frontier for adaptive refinement.

Converging search: numeric axes may be continuous ``Interval(lo, hi)``
ranges instead of discrete value lists, and ``search_until_converged``
closes the refine -> search loop automatically — every round re-anchors on
the incumbent frontier, refines the space around it, and stops when the
frontier's hypervolume improvement falls below ``tol``.  One unpipelined
baseline simulation and one ``FloorplanCache`` (memoized ILP floorplans,
``autobridge.floorplan_counts()``) are shared across all rounds, so
revisited configurations cost a dict lookup instead of an ILP solve.

``docs/search-guide.md`` is the reference's end-to-end guide; every
recipe there carries over with ``repro_torch`` for ``repro`` and a
``device=``.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Mapping, Sequence

from repro_torch.core.autobridge import (FloorplanCache, Plan,
                                         _graph_signature, _grid_signature,
                                         autobridge)
from repro_torch.core.balance import CycleError, balance_graph
from repro_torch.core.devicegrid import SlotGrid
from repro_torch.core.fmax_model import PhysicalModel, TimingReport, analyze_timing
from repro_torch.core.graph import TaskGraph
from repro_torch.core.ilp import InfeasibleError
from repro_torch.core.pipelining import assign_pipelining
from repro_torch.core.simulate import (_ENGINE_INVOCATIONS, SimJob,
                                       SimResult, StreamProfile,
                                       _sweep_device, engine_counts,
                                       reset_engine_counts, simulate,
                                       simulate_batch)

from ..obs import trace as _trace
from . import faults
from .pareto import hypervolume, objective_vector, pareto_indices
from .pool import PoolStats, warm_floorplan_cache
from .space import (DEFAULT_UTILS, Interval, SearchPoint,  # noqa: F401
                    SearchSpace)
from .store import DiskFloorplanStore, SearchJournal, key_digest
from .surrogate import make_proposer

#: the ``simulate_batch`` backends a search may name
SIM_BACKENDS = ("auto", "torch", "numpy", "event")


def _check_backend(backend: str | None) -> None:
    """Refuse a backend ``simulate_batch`` does not have before any work
    is done; the reference's ``"jax"`` is named by its port's name."""
    if backend is not None and backend not in SIM_BACKENDS:
        raise ValueError(
            f"unknown sim backend {backend!r}: the port's are "
            f"{', '.join(map(repr, SIM_BACKENDS))} ('torch' is the "
            f"sim_sweep kernel, the reference's 'jax' sweep)")


@dataclasses.dataclass
class Candidate:
    max_util: float
    plan: Plan | None
    report: TimingReport | None
    error: str | None = None
    #: dataflow-simulated cycles of the pipelined+balanced design (filled by
    #: the batched throughput evaluation; None when not requested/feasible)
    sim: SimResult | None = None
    #: cycles of the unpipelined baseline design (shared across candidates)
    base_sim: SimResult | None = None
    #: the joint knob configuration that produced this candidate
    point: SearchPoint | None = None
    #: event-engine occupancy profiles (``fifo_sizing``, frontier only)
    profile: dict[str, StreamProfile] | None = None
    #: per-stream FIFO headroom re-sized to observed peak occupancy
    #: (reverted to None if the verification batch saw different cycles)
    sized_capacity: dict[str, int] | None = None
    #: verified run of the re-sized design — cycle-identical to the
    #: uniform-headroom reference at the same firing count, or None if the
    #: sizing was reverted
    sized_sim: SimResult | None = None
    #: timing of the sized design with its (smaller) buffering footprint
    #: charged into slot utilization (``analyze_timing(buffer_bits=...)``) —
    #: reclaimed BRAM/LUT credited back, so never below ``uniform_report``
    sized_report: TimingReport | None = None
    #: the uniform-headroom twin scored under the same buffering charge
    #: (the comparison anchor for the FIFO-sizing credit)
    uniform_report: TimingReport | None = None

    @property
    def fmax(self) -> float:
        return self.report.fmax_mhz if self.report else 0.0

    @property
    def throughput_preserved(self) -> bool | None:
        """True iff the simulated candidate kept the baseline's steady-state
        throughput (only fill/drain skew added).  None when not simulated."""
        if self.sim is None or self.base_sim is None or self.plan is None:
            return None
        if self.sim.deadlocked:
            return False
        skew = sum(self.plan.depth.values()) + self.plan.graph.num_tasks
        return self.sim.cycles <= self.base_sim.cycles + skew

    @property
    def fifo_savings_bits(self) -> float | None:
        """Width-weighted capacity saved by profile-driven sizing vs the
        uniform ``2*latency`` headroom (None until sized)."""
        if self.sized_capacity is None or self.plan is None:
            return None
        width = {s.name: s.width for s in self.plan.graph.streams}
        uniform = self.plan.sim_extra_capacity
        return sum((uniform.get(n, 0) - e) * width.get(n, 0.0)
                   for n, e in self.sized_capacity.items())


# ---------------------------------------------------------------------------
# Pareto pruning (candidate level; vector primitives live in .pareto)
# ---------------------------------------------------------------------------

#: the maximized objective vector shared by ``pareto_frontier``, the
#: hypervolume trajectory and the surrogate's training targets — one
#: definition, in ``repro_torch.search.pareto`` (historical private name kept:
#: tests and downstream code import ``_objective`` from here/explorer)
_objective = objective_vector


def pareto_frontier(cands: Sequence[Candidate]) -> list[Candidate]:
    """Feasible, routed, non-deadlocked candidates that are Pareto-optimal
    over (fmax up, area_overhead down, simulated cycles down)."""
    ok = [c for c in cands
          if c.plan is not None and c.report and c.report.routed
          and (c.sim is None or not c.sim.deadlocked)]
    return [ok[i] for i in pareto_indices([_objective(c) for c in ok])]


# ---------------------------------------------------------------------------
# joint search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchResult:
    #: every evaluated configuration, in enumeration order (failures kept —
    #: the paper's Table 10 reports those as 'Failed')
    candidates: list[Candidate]
    #: Pareto-optimal subset over (fmax, area_overhead, sim cycles)
    frontier: list[Candidate]
    #: number of ``simulate_batch`` calls the search issued
    sim_calls: int
    #: number of configurations evaluated
    space_size: int

    @property
    def best(self) -> Candidate:
        """Highest-fmax routable candidate (frontier first)."""
        return best_candidate(self.frontier or self.candidates)


def _derive_depth_variant(graph: TaskGraph, grid: SlotGrid, base: Plan,
                          pt: SearchPoint,
                          **ab_kwargs) -> Plan | InfeasibleError:
    """Re-pipeline + re-balance ``base``'s floorplan under ``pt``'s depth
    scale.  The floorplan is depth-invariant, so this skips the ILP; a
    (theoretically unreachable) balance cycle falls back to a full
    autobridge run with the point's knobs."""
    sgrid = grid.with_hbm_binding(pt.hbm_split).with_knobs(
        row_weight=pt.row_weight, col_weight=pt.col_weight,
        depth_scale=pt.depth_scale)
    fp = dataclasses.replace(base.floorplan, grid=sgrid)
    pa = assign_pipelining(graph, fp)
    try:
        bal = balance_graph(graph, pa.lat)
    except CycleError:
        try:
            return autobridge(graph, grid, max_util=pt.max_util, seed=pt.seed,
                              row_weight=pt.row_weight,
                              col_weight=pt.col_weight,
                              depth_scale=pt.depth_scale,
                              hbm_split=pt.hbm_split, **ab_kwargs)
        except InfeasibleError as err:
            return err
    depth = {name: pa.lat[name] + bal.balance[name] for name in pa.lat}
    width = {s.name: s.width for s in graph.streams}
    overhead = sum(d * width[n] for n, d in depth.items())
    return Plan(graph=graph, floorplan=fp, pipelining=pa, balancing=bal,
                depth=depth, area_overhead=overhead,
                feedback_rounds=base.feedback_rounds,
                co_located=base.co_located,
                demoted_streams=list(base.demoted_streams))


@dataclasses.dataclass
class DeferredSearch:
    """Candidate enumeration with throughput scoring deferred.

    ``prepare_design_space`` runs the floorplan -> pipeline -> balance
    co-optimization and the physical model for every point but leaves the
    simulator out, so a caller can pool the simulation jobs of *many*
    searches — different designs, different device grids — into one
    ``simulate_batch`` call (mixed topologies vectorize through the padded
    backend).  ``sim_jobs`` exposes this search's slice of jobs,
    ``attach_sim`` distributes that call's results back onto the
    candidates, and ``finish`` computes the Pareto frontier.

    ``base_sim`` carries an already-simulated unpipelined baseline: when
    set (``search_until_converged`` reuses round 1's baseline this way),
    ``sim_jobs`` omits the baseline job and ``attach_sim`` stamps the
    stored result onto every candidate instead."""
    graph: TaskGraph
    grid: SlotGrid
    model: PhysicalModel
    candidates: list[Candidate]
    space_size: int
    base_sim: SimResult | None = None
    #: worker-pool activity of the preparation phase (None when ``jobs=1``)
    pool: PoolStats | None = None
    #: run the static pre-flight gate before simulating candidates
    #: (``prepare_design_space(static_check=...)``)
    static_check: bool = True
    #: ``simulate_batch`` backend this search's jobs should be scored with
    #: ("auto" / "torch" / "numpy" / "event"; honored by
    #: ``pool_simulations`` and the drivers that consume ``sim_jobs()``).
    #: The device is not carried here: the function that scores the jobs
    #: takes it.
    sim_backend: str = "auto"

    @property
    def feasible(self) -> list[Candidate]:
        return [c for c in self.candidates if c.plan is not None]

    def _pending(self) -> list[Candidate]:
        """Feasible candidates still awaiting a simulation result (the
        static gate stamps doomed candidates' ``sim`` up front, so they
        drop out of the job list here)."""
        return [c for c in self.candidates
                if c.plan is not None and c.sim is None]

    def apply_static_gate(self, firings: int) -> int:
        """Statically verify every pending candidate's *as-simulated* graph
        variant (``repro_torch.analysis`` deadlock pass over the plan's graph —
        including any cycle-breaking stream demotions — at the plan's FIFO
        headroom) and skip the simulation of provably-doomed ones.

        A skipped candidate gets a synthetic ``SimResult`` with
        ``deadlocked=True`` and ``engine="static"`` — by the soundness of
        the analyzer (a doomed verdict implies the event engine deadlocks)
        this is exactly the verdict the skipped simulation would have
        produced, so the Pareto frontier is bit-identical to the ungated
        path while the doomed candidates' simulations never run.  Returns
        the number of candidates skipped (also accumulated into
        ``analysis_counts()['skipped']``)."""
        if not self.static_check or not firings:
            return 0
        from repro_torch.analysis import analyze
        from repro_torch.analysis.report import _ANALYSIS_COUNTS
        skipped = 0
        for c in self._pending():
            job = c.plan.sim_job()
            rep = analyze(job.graph, extra_capacity=job.extra_capacity,
                          firings=firings, passes=("deadlock",))
            if rep.deadlock:
                c.sim = SimResult(
                    cycles=0, fired={n: 0 for n in job.graph.tasks},
                    deadlocked=True, steps=0, engine="static")
                c.error = ("static deadlock: "
                           + "; ".join(d.message for d in rep.errors))
                skipped += 1
        _ANALYSIS_COUNTS["skipped"] += skipped
        return skipped

    def sim_jobs(self) -> list[SimJob]:
        """The shared unpipelined baseline (omitted when ``base_sim`` is
        already known) followed by one job per pending feasible candidate
        (empty when there is nothing left to simulate)."""
        feas = self._pending()
        if not feas:
            return []
        jobs = [c.plan.sim_job() for c in feas]
        if self.base_sim is None:
            jobs.insert(0, SimJob(self.graph))
        return jobs

    def attach_sim(self, results: Sequence[SimResult]) -> None:
        """Distribute ``simulate_batch`` results produced from
        ``sim_jobs()`` (same order: baseline first unless ``base_sim``
        was supplied up front)."""
        feas = self._pending()
        if not feas:
            return
        if self.base_sim is None:
            self.base_sim = results[0]
            results = results[1:]
        for c, res in zip(feas, results):
            c.sim = res
            c.base_sim = self.base_sim

    def finish(self, *, sim_calls: int = 0) -> SearchResult:
        return SearchResult(candidates=self.candidates,
                            frontier=pareto_frontier(self.candidates),
                            sim_calls=sim_calls,
                            space_size=self.space_size)


def gather_sim_jobs(preps: Sequence[DeferredSearch], *,
                    firings: int) -> tuple[list[SimJob],
                                           list[tuple[int, int]]]:
    """Apply the static pre-flight gate and collect every search's pending
    simulation jobs into one flat list.  Returns ``(jobs, spans)`` where
    ``spans[i]`` is search i's slice of ``jobs`` — feed the batched results
    back with ``scatter_sim_results``.  Split out of ``pool_simulations``
    so drivers can hold on to the job list (e.g. to re-time it under
    another backend with ``measure_backend_speedup``)."""
    jobs: list[SimJob] = []
    spans: list[tuple[int, int]] = []
    for prep in preps:
        prep.apply_static_gate(firings)
    for prep in preps:
        pj = prep.sim_jobs()
        spans.append((len(jobs), len(jobs) + len(pj)))
        jobs.extend(pj)
    return jobs, spans


def scatter_sim_results(preps: Sequence[DeferredSearch],
                        spans: Sequence[tuple[int, int]],
                        results: Sequence[SimResult]) -> None:
    """Distribute one batched call's results back onto the searches whose
    jobs ``gather_sim_jobs`` collected (inverse of the concatenation)."""
    for prep, (lo, hi) in zip(preps, spans):
        prep.attach_sim(results[lo:hi])


def _resolve_backend(preps: Sequence[DeferredSearch],
                     backend: str | None) -> str:
    """An explicit ``backend`` wins; otherwise the searches' unanimous
    ``sim_backend``, or "auto" when they disagree."""
    _check_backend(backend)
    if backend is not None:
        return backend
    kinds = {p.sim_backend for p in preps}
    return kinds.pop() if len(kinds) == 1 else "auto"


def pool_simulations(preps: Sequence[DeferredSearch], *, firings: int,
                     backend: str | None = None,
                     device="cuda") -> list[SimResult]:
    """Score many deferred searches' jobs in ONE ``simulate_batch`` call.

    Concatenates every search's ``sim_jobs()``, runs the single batched
    call on ``device`` (mixed topologies vectorize through the padded
    layout), and distributes each search's slice back via ``attach_sim``.
    ``backend`` forces a ``simulate_batch`` backend; by default the
    searches' own ``sim_backend`` is used (falling back to "auto" when they
    disagree).  Returns the flat result list ([] when there was nothing to
    score) so callers can record metadata such as the engines used."""
    _sweep_device(device)
    resolved = _resolve_backend(preps, backend)
    jobs, spans = gather_sim_jobs(preps, firings=firings)
    if not jobs:
        return []
    results = simulate_batch(jobs, firings=firings, backend=resolved,
                             device=device)
    scatter_sim_results(preps, spans, results)
    return results


def measure_backend_speedup(jobs: Sequence[SimJob], *, firings: int,
                            device="cuda") -> dict:
    """Measured NumPy-vs-torch wall time on one job list (the BENCH JSON
    ``sim.speedup`` block): times the padded NumPy sweep, then the torch
    sweep on ``device`` twice.  The first call (``torch_first_s``) builds
    the ``sim_sweep`` kernel if this process has not built it yet; the
    second (``torch_wall_s``) is the one ``speedup`` divides by.  Each
    wall time ends when the results are on the host.  Engine counters are
    restored afterwards so gates on the main call's counts stay
    unpolluted."""
    _sweep_device(device)
    jobs = list(jobs)
    saved = dict(_ENGINE_INVOCATIONS)
    try:
        t0 = time.monotonic()
        simulate_batch(jobs, firings=firings, backend="numpy",
                       device=device)
        numpy_wall = time.monotonic() - t0
        t0 = time.monotonic()
        simulate_batch(jobs, firings=firings, backend="torch", device=device)
        first = time.monotonic() - t0
        t0 = time.monotonic()
        simulate_batch(jobs, firings=firings, backend="torch", device=device)
        wall = time.monotonic() - t0
        return {"jobs": len(jobs), "firings": firings,
                "numpy_wall_s": numpy_wall, "torch_first_s": first,
                "torch_wall_s": wall,
                "speedup": numpy_wall / max(wall, 1e-9)}
    finally:
        _ENGINE_INVOCATIONS.clear()
        _ENGINE_INVOCATIONS.update(saved)


def timed_pool_simulations(preps: Sequence[DeferredSearch], *, firings: int,
                           backend: str | None = None,
                           measure_speedup: bool = False,
                           device="cuda") -> tuple[list[SimResult], dict]:
    """``pool_simulations`` plus the benchmark drivers' metadata recording:
    resets the global engine counters, times the batched call on
    ``device``, and returns ``(results, meta)`` where ``meta`` is the
    JSON-ready dict a ``BENCH_*.json`` writer stores under its top-level
    ``"sim"`` key — ``{firings, jobs, invocations, counts, backends,
    backend, wall_s, analysis}`` — and a regression gate inspects to prove
    the suite stayed vectorized (and, via ``analysis``, that the static
    pre-flight gate actually ran).  ``analysis`` is a *snapshot* of
    ``analysis_counts()``, not a delta: drivers reset the counters up
    front so the snapshot also covers the preparation phase's
    ``autobridge(check=True)`` verdicts.

    There is no ``jit_cache`` key: the reference records its jitted
    sweep's compile cache there, and nothing in the port compiles per
    shape (the ``sim_sweep`` kernel is built once per process, for every
    batch shape).  ``measure_speedup=True`` re-times the same job list
    under both array backends into ``meta["speedup"]``
    (``measure_backend_speedup``) — after the counts snapshot, so the
    gates' counters stay clean."""
    from repro_torch.analysis import analysis_counts
    _sweep_device(device)
    resolved = _resolve_backend(preps, backend)
    reset_engine_counts()
    t0 = time.monotonic()
    jobs, spans = gather_sim_jobs(preps, firings=firings)
    results = (simulate_batch(jobs, firings=firings, backend=resolved,
                              device=device)
               if jobs else [])
    wall = time.monotonic() - t0
    counts = engine_counts()
    meta = {"firings": firings, "jobs": len(results),
            "invocations": sum(counts.values()), "counts": counts,
            "backends": sorted({r.engine for r in results}),
            "backend": resolved,
            "wall_s": wall,
            "analysis": analysis_counts()}
    if measure_speedup and jobs:
        meta["speedup"] = measure_backend_speedup(jobs, firings=firings,
                                                  device=device)
    scatter_sim_results(preps, spans, results)
    return results, meta


def prepare_design_space(graph: TaskGraph, grid: SlotGrid, *,
                         jobs: int = 1, **kwargs) -> DeferredSearch:
    """Span-wrapped front door of ``_prepare_design_space`` (which holds
    the real signature and documentation): everything between here and
    the deferred simulation — point enumeration, pool warm-up, the
    in-process autobridge replay and physical scoring — is one
    ``search.prepare`` trace span."""
    with _trace.span("search.prepare", jobs=jobs if jobs > 1 else None):
        return _prepare_design_space(graph, grid, jobs=jobs, **kwargs)


def _prepare_design_space(graph: TaskGraph, grid: SlotGrid, *,
                         space: SearchSpace | None = None,
                         mode: str = "grid",
                         n_samples: int = 64,
                         sample_seed: int = 0,
                         points: Sequence[SearchPoint] | None = None,
                         model: PhysicalModel | None = None,
                         score: Callable[[Plan], TimingReport] | None = None,
                         floorplan_cache: FloorplanCache | None = None,
                         base_sim: SimResult | None = None,
                         jobs: int = 1,
                         static_check: bool = True,
                         sim_backend: str = "auto",
                         **ab_kwargs) -> DeferredSearch:
    """Enumerate and physically score every search point, deferring the
    batched throughput simulation to the caller (see ``DeferredSearch``).

    mode    — "grid" sweeps the full cartesian product of ``space``;
              "random" draws ``n_samples`` distinct points from it.  A
              continuous space (``Interval`` axes) cannot be enumerated,
              so "grid" silently degrades to "random" there.
    points  — explicit point list (e.g. from ``SearchSpace.refine``);
              overrides ``mode``
    floorplan_cache — memoizes the ILP floorplan solves across calls
              (refine rounds, device sweeps); see ``FloorplanCache``
    base_sim — an already-simulated unpipelined baseline to reuse instead
              of scheduling the baseline job again (``DeferredSearch``)
    jobs    — fan the points' cold floorplan solves out over a process
              pool of this many workers (``repro_torch.search.pool``), then
              replay in-process against the merged cache; ``jobs=1`` is
              the exact sequential path (results are bit-identical either
              way, the pool only moves the ILP wall time)
    static_check — pre-flight static verification (``repro_torch.analysis``):
              ``autobridge`` refuses structurally-broken graphs before the
              ILP (verdict cached in the floorplan cache) and, once a
              firing count is known, ``DeferredSearch.apply_static_gate``
              skips the simulation of provably-deadlocked candidates.
              The produced frontier is bit-identical to
              ``static_check=False`` by the analyzer's soundness; only the
              doomed work disappears (counted by ``analysis_counts()``).
    sim_backend — ``simulate_batch`` backend the deferred jobs should be
              scored with ("auto"/"torch"/"numpy"/"event"); recorded on the
              returned ``DeferredSearch`` and honored by
              ``pool_simulations``/``timed_pool_simulations``, which also
              take the device.  Nothing here touches the card.
    """
    _check_backend(sim_backend)
    model = model or PhysicalModel()
    space = space or SearchSpace()
    if static_check:
        ab_kwargs = {**ab_kwargs, "check": True}
    if mode == "grid" and space.continuous and points is None:
        mode = "random"
    if points is not None:
        points = list(points)
    elif mode == "grid":
        points = space.grid_points()
    elif mode == "random":
        points = space.sample(n_samples, seed=sample_seed)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    pool_stats: PoolStats | None = None
    if jobs > 1:
        if floorplan_cache is None:
            floorplan_cache = FloorplanCache()
        uniq: list[SearchPoint] = []
        seen_keys: set[tuple] = set()
        for pt in points:
            if pt.floorplan_key not in seen_keys:
                seen_keys.add(pt.floorplan_key)
                uniq.append(pt)
        pool_stats = warm_floorplan_cache(graph, grid, uniq,
                                          cache=floorplan_cache, jobs=jobs,
                                          ab_kwargs=ab_kwargs)
    if floorplan_cache is not None:
        ab_kwargs = {**ab_kwargs, "cache": floorplan_cache}

    cands: list[Candidate] = []
    plans: dict[tuple, tuple[float, Plan | InfeasibleError]] = {}
    # autobridge's cycle-breaking last resort mutates the input graph
    # (stream demotion, autobridge.py) — under a joint sweep that would
    # leak one point's demotion into every later point, the shared
    # baseline, and the caller's graph.  Snapshot the control flags and
    # confine any demotion to a per-candidate graph copy.
    ctrl0 = [s.control for s in graph.streams]

    def _restore_ctrl() -> bool:
        changed = False
        for s, c0 in zip(graph.streams, ctrl0):
            if s.control != c0:
                s.control = c0
                changed = True
        return changed

    def _run_autobridge(g: TaskGraph, pt: SearchPoint):
        return autobridge(g, grid, max_util=pt.max_util, seed=pt.seed,
                          row_weight=pt.row_weight, col_weight=pt.col_weight,
                          depth_scale=pt.depth_scale,
                          hbm_split=pt.hbm_split, **ab_kwargs)

    for pt in points:
        entry = plans.get(pt.floorplan_key)
        if entry is None:
            try:
                made = _run_autobridge(graph, pt)
            except InfeasibleError as err:
                made = err
            if _restore_ctrl() and not isinstance(made, InfeasibleError):
                # this point needs the demotion: re-run on a private copy so
                # the candidate keeps a consistent graph while the shared
                # one stays pristine (simulate_batch groups the split
                # topology separately inside the same padded array-sweep)
                try:
                    made = _run_autobridge(copy.deepcopy(graph), pt)
                except InfeasibleError as err:
                    made = err
                _restore_ctrl()
            entry = (pt.depth_scale, made)
            plans[pt.floorplan_key] = entry
        base_scale, base = entry
        if isinstance(base, InfeasibleError):
            cands.append(Candidate(max_util=pt.max_util, plan=None,
                                   report=None, error=str(base), point=pt))
            continue
        if pt.depth_scale == base_scale:
            plan = base
        else:
            plan = _derive_depth_variant(base.graph, grid, base, pt,
                                         **ab_kwargs)
            if isinstance(plan, InfeasibleError):
                cands.append(Candidate(max_util=pt.max_util, plan=None,
                                       report=None, error=str(plan),
                                       point=pt))
                continue
        if score is not None:
            rep = score(plan)
        else:
            rep = analyze_timing(plan.graph, grid, plan.floorplan.placement,
                                 plan.depth, model)
        cands.append(Candidate(max_util=pt.max_util, plan=plan, report=rep,
                               point=pt))

    return DeferredSearch(graph=graph, grid=grid, model=model,
                          candidates=cands, space_size=len(points),
                          base_sim=base_sim, pool=pool_stats,
                          static_check=static_check, sim_backend=sim_backend)


def _buffer_bits(plan: Plan, extra_capacity: dict[str, int]) -> dict[str, float]:
    """Per-stream inserted buffering in bits: declared FIFO storage plus
    pipeline registers plus the given headroom, width-weighted — the
    quantity ``analyze_timing(buffer_bits=...)`` charges into slots."""
    return {s.name: (int(s.depth) + plan.depth.get(s.name, 0)
                     + extra_capacity.get(s.name, 0)) * s.width
            for s in plan.graph.streams}


def _size_fifos(res: SearchResult, grid: SlotGrid, model: PhysicalModel,
                firings: int, backend: str = "auto",
                device="cuda") -> None:
    """Profile-driven FIFO sizing of the frontier (one more batch call),
    plus the area-model feedback: both the sized design and its
    uniform-headroom twin are re-scored with their buffering footprint
    charged into slot utilization, so reclaimed bits show up as fmax.  The
    profiles come from the event engine on the host; the verification
    batch runs on ``device``."""
    _sweep_device(device)
    frontier = res.frontier
    jobs = []
    for c in frontier:
        g = c.plan.graph
        prof = simulate(g, firings=firings, latency=c.plan.depth,
                        extra_capacity=c.plan.sim_extra_capacity,
                        profile=True)
        c.profile = prof.profiles
        # observed-peak trimming: occupancy never exceeded peak, so
        # capacity=peak admits the exact same firing schedule.  Streams the
        # profiler does not model (control streams) keep their uniform
        # headroom — they were never observed, so nothing was reclaimed and
        # no area credit may be taken for them.
        declared = {s.name: int(s.depth) for s in g.streams}
        c.sized_capacity = dict(c.plan.sim_extra_capacity)
        c.sized_capacity.update({name: max(0, p.peak - declared[name])
                                 for name, p in prof.profiles.items()})
        # sized variant paired with its uniform-headroom reference at
        # the *same* firing count, so the verdict below is well-defined
        # even when fifo_firings != sim_firings
        jobs.append(SimJob(g, latency=dict(c.plan.depth),
                           extra_capacity=dict(c.sized_capacity)))
        jobs.append(c.plan.sim_job())
    results = simulate_batch(jobs, firings=firings, backend=backend,
                             device=device)
    res.sim_calls += 1
    for i, c in enumerate(frontier):
        sized, uniform = results[2 * i], results[2 * i + 1]
        if sized.deadlocked or sized.cycles != uniform.cycles:
            # trimming broke the schedule (theoretically unreachable):
            # revert rather than hand out an unverified sizing
            c.sized_capacity = None
            c.sized_sim = None
            continue
        c.sized_sim = sized
        placement = c.plan.floorplan.placement
        c.uniform_report = analyze_timing(
            c.plan.graph, grid, placement, c.plan.depth, model,
            buffer_bits=_buffer_bits(c.plan, c.plan.sim_extra_capacity))
        c.sized_report = analyze_timing(
            c.plan.graph, grid, placement, c.plan.depth, model,
            buffer_bits=_buffer_bits(c.plan, c.sized_capacity))


def explore_design_space(graph: TaskGraph, grid: SlotGrid, *,
                         space: SearchSpace | None = None,
                         mode: str = "grid",
                         n_samples: int = 64,
                         sample_seed: int = 0,
                         points: Sequence[SearchPoint] | None = None,
                         model: PhysicalModel | None = None,
                         score: Callable[[Plan], TimingReport] | None = None,
                         sim_firings: int | None = None,
                         fifo_sizing: bool = False,
                         fifo_firings: int | None = None,
                         jobs: int = 1,
                         static_check: bool = True,
                         sim_backend: str = "auto",
                         device="cuda",
                         **ab_kwargs) -> SearchResult:
    """Joint batched design-space search (see module docstring).

    mode         — "grid" sweeps the full cartesian product of ``space``;
                   "random" draws ``n_samples`` distinct points from it
    points       — explicit point list (``SearchSpace.refine`` output);
                   overrides ``mode``
    sim_firings  — when set, score *all* feasible candidates' throughput in
                   one vectorized ``simulate_batch`` call (plus the shared
                   unpipelined baseline)
    fifo_sizing  — profile frontier candidates with the event engine and
                   re-size their FIFO headroom to observed peak occupancy;
                   one more batch call verifies cycles are unchanged, and
                   the reclaimed bits are credited back into slot
                   utilization (``sized_report`` vs ``uniform_report``)
    jobs         — worker processes for the cold floorplan solves
                   (``jobs=1`` = exact sequential path, same results)
    static_check — pre-flight static verification gate (see
                   ``prepare_design_space``); frontier unchanged by
                   construction, doomed candidates never simulated
    sim_backend  — ``simulate_batch`` backend for the throughput scoring
                   (and FIFO-sizing verification) calls
    device       — where those calls run: ``"cuda"`` (default) or
                   ``"cpu"``; checked before any work, so without a card
                   a call that did not pass ``"cpu"`` raises
                   ``RuntimeError``
    ab_kwargs    — forwarded to ``autobridge`` (e.g. ``same_slot``)

    >>> from repro_torch.core import (SearchSpace, SlotGrid,
    ...                               TaskGraphBuilder, explore_design_space)
    >>> b = TaskGraphBuilder("chain")
    >>> _ = b.stream("s0", width=64)
    >>> _ = b.invoke("P", area={"LUT": 100}, outs=["s0"])
    >>> _ = b.invoke("C", area={"LUT": 100}, ins=["s0"])
    >>> grid = SlotGrid("g", rows=1, cols=2, base_capacity={"LUT": 150},
    ...                 max_util=1.0)
    >>> res = explore_design_space(b.build(), grid,
    ...                            space=SearchSpace(utils=(0.9, 1.0)),
    ...                            sim_firings=50, device="cpu")
    >>> res.space_size, res.sim_calls
    (2, 1)
    >>> res.best.throughput_preserved
    True
    """
    _sweep_device(device)
    model = model or PhysicalModel()
    prep = prepare_design_space(graph, grid, space=space, mode=mode,
                                n_samples=n_samples, sample_seed=sample_seed,
                                points=points, model=model, score=score,
                                jobs=jobs, static_check=static_check,
                                sim_backend=sim_backend, **ab_kwargs)
    sim_calls = 0
    if sim_firings:
        prep.apply_static_gate(sim_firings)
        jobs_list = prep.sim_jobs()
        if jobs_list:
            prep.attach_sim(simulate_batch(jobs_list, firings=sim_firings,
                                           backend=sim_backend,
                                           device=device))
            sim_calls += 1
    res = prep.finish(sim_calls=sim_calls)
    if fifo_sizing and res.frontier:
        _size_fifos(res, grid, model, fifo_firings or sim_firings or 200,
                    backend=sim_backend, device=device)
    return res


# ---------------------------------------------------------------------------
# converging search: refine -> search until the frontier stops moving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConvergedSearch:
    """Result of ``search_until_converged``: per-round results, the merged
    Pareto frontier over every evaluated point, and the hypervolume
    trajectory that decided convergence."""
    #: per-round ``SearchResult``s, in execution order
    rounds: list[SearchResult]
    #: Pareto frontier over the union of all rounds' candidates
    frontier: list[Candidate]
    #: merged-frontier hypervolume after each round (monotone by
    #: construction: the merged frontier only ever gains points)
    hypervolumes: list[float]
    #: the fixed reference point the hypervolumes are measured against
    #: (established from round 1's feasible candidates)
    ref: tuple[float, float, float] | None
    #: True when the relative hypervolume improvement fell below ``tol``
    #: before the round budget ran out
    converged: bool
    #: total ``simulate_batch`` calls across all rounds (the baseline is
    #: simulated once, in round 1, and reused)
    sim_calls: int
    #: total configurations evaluated (across rounds, anchors re-counted)
    points_evaluated: int
    #: the floorplan memoization shared by every round
    cache: FloorplanCache
    #: the round-proposal strategy that drove the search
    proposer: str = "uniform"
    #: worker processes used for the cold floorplan solves
    jobs: int = 1
    #: aggregated worker-pool activity across rounds (None when ``jobs=1``)
    pool: PoolStats | None = None
    #: completed rounds restored from a checkpoint instead of re-run
    #: (0 for a fresh, un-checkpointed or from-scratch search)
    resumed_rounds: int = 0
    #: the checkpoint directory this search journals to (None = volatile)
    checkpoint_dir: str | None = None

    @property
    def rounds_run(self) -> int:
        return len(self.rounds)

    @property
    def best(self) -> Candidate:
        """Highest-fmax routable candidate on the merged frontier."""
        return best_candidate(self.frontier)


def search_until_converged(graph: TaskGraph, grid: SlotGrid, *,
                           space: SearchSpace | None = None,
                           rounds: int = 4,
                           tol: float = 0.02,
                           points_per_round: int = 24,
                           sim_firings: int | None = 200,
                           sample_seed: int = 0,
                           initial_points: Sequence[SearchPoint] | None = None,
                           model: PhysicalModel | None = None,
                           cache: FloorplanCache | None = None,
                           jobs: int = 1,
                           proposer="uniform",
                           static_check: bool = True,
                           sim_backend: str = "auto",
                           checkpoint: str | os.PathLike | None = None,
                           device="cuda",
                           **ab_kwargs) -> ConvergedSearch:
    """Converging design-space search: iterate refine -> search until the
    Pareto frontier's hypervolume stops improving.

    Round 1 samples ``points_per_round`` configurations from ``space``
    (continuous ``Interval`` axes draw uniformly; ``initial_points``, when
    given, anchor the round — e.g. the discrete sweep a converged run must
    never lose to).  Every later round re-anchors on the incumbent
    frontier's points and *compounds* the zoom: the working space is
    re-narrowed around the frontier each round (``SearchSpace.refined``:
    discrete axes halve their grid pitch, continuous axes shrink their
    range geometrically) and the round's draws come from that ever-tighter
    space.  After each round the frontier is merged across *all* evaluated
    candidates and its hypervolume w.r.t. a fixed reference point (set from
    round 1) is appended to the trajectory; the loop stops when the
    relative improvement falls below ``tol`` or ``rounds`` are exhausted.

    ``jobs=N`` fans each round's cold ILP floorplan solves over a process
    pool and replays against the merged cache — the returned frontier is
    bit-identical to ``jobs=1`` (same draws, same deterministic solves),
    only the sequential ILP wall time goes away.  ``proposer="surrogate"``
    replaces the uniform per-round draws with response-surface-guided
    proposals (``repro_torch.search.surrogate``); the uniform path is untouched
    and remains the default.

    Cost controls built in: the unpipelined baseline is simulated once, in
    round 1, and reused by every later round (``DeferredSearch.base_sim``);
    all rounds share one ``FloorplanCache``, so re-anchored frontier points
    and revisited knob values skip the ILP solve entirely —
    ``floorplan_counts()`` proves it (solves < points evaluated, hits > 0).

    ``checkpoint=dir`` makes the whole search crash-safe: floorplan solves
    persist to a ``DiskFloorplanStore`` under ``dir/store`` (unless an
    explicit ``cache`` is passed) and the end-of-round loop state is
    journaled to ``dir`` (``SearchJournal``), so a process killed at any
    point — even mid-write — resumes from the last completed round and
    reproduces the uninterrupted run's frontier *bit for bit*.  Resuming
    with different search arguments is refused (config fingerprint); a
    search that already ran to completion replays instantly from its final
    checkpoint, with ``resumed_rounds`` saying how much was restored.  See
    ``docs/robustness-guide.md``.  ``device`` is not part of that
    fingerprint: the results are the same on either device, so a search
    checkpointed on the card may resume on the CPU.

    Each round's throughput scoring runs on ``device`` (default
    ``"cuda"``; ``"cpu"`` runs the sweep's plain version on the host),
    checked before any work.  The worker pool (``jobs > 1``) runs only the
    NumPy floorplan chain, so forking it after the card is in use is safe.

    >>> from repro_torch.core import (Interval, SearchSpace, SlotGrid,
    ...                               TaskGraphBuilder,
    ...                               search_until_converged)
    >>> b = TaskGraphBuilder("chain")
    >>> _ = b.stream("s0", width=64)
    >>> _ = b.invoke("P", area={"LUT": 100}, outs=["s0"])
    >>> _ = b.invoke("C", area={"LUT": 100}, ins=["s0"])
    >>> grid = SlotGrid("g", rows=1, cols=2, base_capacity={"LUT": 150},
    ...                 max_util=1.0)
    >>> res = search_until_converged(
    ...     b.build(), grid, space=SearchSpace(utils=Interval(0.8, 1.0)),
    ...     rounds=3, points_per_round=4, sim_firings=50, device="cpu")
    >>> res.rounds_run <= 3 and len(res.frontier) >= 1
    True
    >>> res.hypervolumes == sorted(res.hypervolumes)   # monotone
    True
    >>> res.cache.hits > 0            # refine rounds reuse floorplans
    True
    """
    _sweep_device(device)
    _check_backend(sim_backend)
    model = model or PhysicalModel()
    space = space or SearchSpace()
    cur_space = space
    prop = make_proposer(proposer)

    journal: SearchJournal | None = None
    if checkpoint is not None:
        if cache is None:
            cache = DiskFloorplanStore(os.path.join(checkpoint, "store"))
        # everything that shapes the produced frontier must match for a
        # resume to reproduce the uninterrupted run (jobs / sim_backend /
        # cache / device are excluded on purpose: bit-identity is their
        # contract)
        config = {
            "graph": key_digest(_graph_signature(graph)),
            "grid": key_digest(_grid_signature(grid)),
            "space": repr(space), "rounds": rounds, "tol": tol,
            "points_per_round": points_per_round,
            "sim_firings": sim_firings, "sample_seed": sample_seed,
            "initial_points": repr(tuple(initial_points or ())),
            "proposer": getattr(prop, "name", type(prop).__name__),
            "static_check": static_check,
            "ab_kwargs": repr(tuple(sorted(ab_kwargs.items()))),
        }
        journal = SearchJournal(checkpoint, config=config)
    cache = cache if cache is not None else FloorplanCache()
    total_pool = PoolStats(jobs=max(jobs, 1)) if jobs > 1 else None
    pts: list[SearchPoint] = list(initial_points or ())
    if len(pts) < points_per_round:
        have = set(pts)
        for p in space.sample(points_per_round, seed=sample_seed):
            if len(pts) >= points_per_round:
                break
            if p not in have:
                have.add(p)
                pts.append(p)

    results: list[SearchResult] = []
    evaluated: list[Candidate] = []     # deduplicated by point
    seen_pts: set[SearchPoint] = set()
    hvs: list[float] = []
    ref: tuple[float, float, float] | None = None
    base_sim: SimResult | None = None
    sim_calls = 0
    points_evaluated = 0
    converged = False
    frontier: list[Candidate] = []
    start_round = 0
    resumed_rounds = 0

    state = journal.load_latest() if journal is not None else None
    if state is not None:
        cur_space = state["cur_space"]
        pts = state["pts"]
        results = state["results"]
        evaluated = state["evaluated"]
        seen_pts = state["seen_pts"]
        hvs = state["hvs"]
        ref = state["ref"]
        base_sim = state["base_sim"]
        sim_calls = state["sim_calls"]
        points_evaluated = state["points_evaluated"]
        converged = state["converged"]
        frontier = pareto_frontier(evaluated)
        start_round = state["round_next"]
        resumed_rounds = state["round"] + 1
        if state.get("pool") is not None:
            if total_pool is not None:
                total_pool.absorb(state["pool"])
            else:
                total_pool = state["pool"]

    def _checkpoint_round(r: int) -> None:
        """Persist the end-of-round state (the commit point resume trusts)
        then visit the ``parent_kill`` fault site — the chaos drill
        SIGKILLs exactly here, after the state is durable."""
        if journal is not None:
            journal.save_round(r, {
                "round_next": r + 1, "cur_space": cur_space, "pts": pts,
                "results": results, "evaluated": evaluated,
                "seen_pts": seen_pts, "hvs": hvs, "ref": ref,
                "base_sim": base_sim, "sim_calls": sim_calls,
                "points_evaluated": points_evaluated,
                "converged": converged, "pool": total_pool,
                "hypervolume": hvs[-1] if hvs else None,
                "frontier_size": len(frontier)})
        faults.fire("parent_kill", str(r))

    for r in range(start_round, max(rounds, 1)):
        if converged:
            break
        with _trace.span("search.round", round=r,
                         points=len(pts)):
            prep = prepare_design_space(graph, grid, points=pts, model=model,
                                        floorplan_cache=cache,
                                        base_sim=base_sim, jobs=jobs,
                                        static_check=static_check,
                                        sim_backend=sim_backend,
                                        **ab_kwargs)
            if total_pool is not None and prep.pool is not None:
                total_pool.absorb(prep.pool)
            round_calls = 0
            if sim_firings:
                prep.apply_static_gate(sim_firings)
                jobs_list = prep.sim_jobs()
                if jobs_list:
                    prep.attach_sim(simulate_batch(jobs_list,
                                                   firings=sim_firings,
                                                   backend=sim_backend,
                                                   device=device))
                    round_calls = 1
            base_sim = prep.base_sim
            sim_calls += round_calls
            points_evaluated += prep.space_size
            res = prep.finish(sim_calls=round_calls)
            results.append(res)
            for c in res.candidates:
                if c.point is None or c.point not in seen_pts:
                    if c.point is not None:
                        seen_pts.add(c.point)
                    evaluated.append(c)
            frontier = pareto_frontier(evaluated)
            if not frontier:
                # nothing feasible yet: re-sample fresh points and try again
                pts = cur_space.sample(points_per_round,
                                       seed=sample_seed + r + 1)
                _checkpoint_round(r)
                continue
            if ref is None:
                vecs = [_objective(c) for c in evaluated if c.plan is not None
                        and c.report and c.report.routed]
                ref = tuple(min(v[i] for v in vecs) - 1.0 for i in range(3))
            hvs.append(hypervolume([_objective(c) for c in frontier], ref))
            if len(hvs) >= 2:
                prev = hvs[-2]
                if hvs[-1] - prev <= tol * max(abs(prev), 1e-12):
                    converged = True
                    _checkpoint_round(r)
                    break
            if r + 1 < max(rounds, 1):
                anchors = [c.point for c in frontier if c.point is not None]
                # compound the zoom: narrow the working space around the
                # incumbent frontier, then draw the round's points from it —
                # uniformly by default, surrogate-ranked with proposer=
                cur_space = cur_space.refined(frontier)
                fresh = prop.propose(cur_space, frontier, evaluated,
                                     points_per_round,
                                     seed=sample_seed + 101 * (r + 1), ref=ref)
                pts, have = [], set()
                for p in anchors + fresh:
                    if p not in have:
                        have.add(p)
                        pts.append(p)
            _checkpoint_round(r)

    return ConvergedSearch(rounds=results, frontier=frontier,
                           hypervolumes=hvs, ref=ref, converged=converged,
                           sim_calls=sim_calls,
                           points_evaluated=points_evaluated, cache=cache,
                           proposer=getattr(prop, "name",
                                            type(prop).__name__),
                           jobs=max(jobs, 1), pool=total_pool,
                           resumed_rounds=resumed_rounds,
                           checkpoint_dir=(os.fspath(checkpoint)
                                           if checkpoint is not None
                                           else None))


# ---------------------------------------------------------------------------
# one-call multi-device sweeps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BackendSweep:
    """Per-device-grid search results whose throughput scoring shared one
    batched simulator call (``sim_calls`` counts that shared call once)."""
    results: dict[str, SearchResult]
    sim_calls: int

    @property
    def best(self) -> tuple[str, Candidate]:
        """(grid name, candidate) of the highest-fmax routable candidate
        across every grid."""
        picks: dict[str, Candidate] = {}
        for name, res in self.results.items():
            try:
                picks[name] = best_candidate(res.candidates)
            except InfeasibleError:
                continue
        if not picks:
            raise InfeasibleError("no routable candidate on any device grid")
        name = max(picks, key=lambda k: picks[k].fmax)
        return name, picks[name]

    def table(self) -> list[dict]:
        """One comparison row per grid (the multi-device sweep summary)."""
        rows = []
        for name, res in self.results.items():
            try:
                c = best_candidate(res.candidates)
            except InfeasibleError:
                rows.append({
                    "grid": name, "routable": False, "fmax_mhz": 0.0,
                    "util": None, "area_overhead_bits": None,
                    "cycles": None, "throughput_preserved": None,
                    "frontier": len(res.frontier),
                })
                continue
            rows.append({
                "grid": name, "routable": True, "fmax_mhz": c.fmax,
                "util": c.point.max_util if c.point else None,
                "area_overhead_bits": c.plan.area_overhead,
                "cycles": c.sim.cycles if c.sim else None,
                "throughput_preserved": c.throughput_preserved,
                "frontier": len(res.frontier),
            })
        return rows


def sweep_backends(graph: TaskGraph,
                   grids: Mapping[str, SlotGrid] | Sequence[SlotGrid], *,
                   space: SearchSpace | None = None,
                   mode: str = "grid",
                   n_samples: int = 64,
                   sample_seed: int = 0,
                   model: PhysicalModel | None = None,
                   sim_firings: int | None = 200,
                   cache: FloorplanCache | None = None,
                   jobs: int = 1,
                   static_check: bool = True,
                   sim_backend: str = "auto",
                   device="cuda",
                   **ab_kwargs) -> BackendSweep:
    """One-call multi-device sweep: the same design searched across several
    device grids (U250/U280/TPU-pod shapes from ``repro_torch.fpga.archs``), with
    *all* grids' candidates plus their shared baselines scored by a single
    ``simulate_batch`` call — the padded backend vectorizes across the
    per-grid candidate sets even when cycle-breaking stream demotions give
    some candidates a different topology.

    ``grids`` is a name -> ``SlotGrid`` mapping, or a sequence of grids
    keyed by their ``.name`` (duplicates get a ``#2``-style suffix).
    Returns a ``BackendSweep``: per-grid ``SearchResult``s, ``best``
    across grids, and a ``table()`` comparison summary.  All grids share
    one ``FloorplanCache`` (pass ``cache=`` to share it wider), so a grid
    appearing twice — or a later converged search on the same grid — skips
    its ILP solves.  ``jobs=N`` fans each grid's cold floorplan solves
    over a process pool (same results, less wall time).  The shared call
    runs on ``device`` (default ``"cuda"``), checked before any work.

    >>> from repro_torch.core import SearchSpace, SlotGrid, TaskGraphBuilder
    >>> from repro_torch.core import sweep_backends
    >>> b = TaskGraphBuilder("chain")
    >>> _ = b.stream("s0", width=64)
    >>> _ = b.invoke("P", area={"LUT": 100}, outs=["s0"])
    >>> _ = b.invoke("C", area={"LUT": 100}, ins=["s0"])
    >>> small = SlotGrid("small", rows=1, cols=2,
    ...                  base_capacity={"LUT": 150}, max_util=1.0)
    >>> wide = SlotGrid("wide", rows=1, cols=4,
    ...                  base_capacity={"LUT": 300}, max_util=1.0)
    >>> sweep = sweep_backends(b.build(), {"small": small, "wide": wide},
    ...                        space=SearchSpace(utils=(0.9, 1.0)),
    ...                        sim_firings=50, device="cpu")
    >>> sorted(sweep.results), sweep.sim_calls
    (['small', 'wide'], 1)
    >>> name, champ = sweep.best
    >>> champ.plan is not None
    True
    """
    _sweep_device(device)
    model = model or PhysicalModel()
    if isinstance(grids, Mapping):
        named = dict(grids)
    else:
        named = {}
        for g in grids:
            key = g.name
            i = 2
            while key in named:
                key = f"{g.name}#{i}"
                i += 1
            named[key] = g
    if not named:
        raise ValueError("sweep_backends needs at least one device grid")

    cache = cache or FloorplanCache()
    preps = {name: prepare_design_space(graph, g, space=space, mode=mode,
                                        n_samples=n_samples,
                                        sample_seed=sample_seed, model=model,
                                        floorplan_cache=cache, jobs=jobs,
                                        static_check=static_check,
                                        sim_backend=sim_backend,
                                        **ab_kwargs)
             for name, g in named.items()}
    sim_calls = 0
    if sim_firings and pool_simulations(list(preps.values()),
                                       firings=sim_firings, device=device):
        sim_calls = 1
    return BackendSweep(
        results={name: prep.finish(sim_calls=sim_calls)
                 for name, prep in preps.items()},
        sim_calls=sim_calls)


# ---------------------------------------------------------------------------
# single-axis compatibility wrapper (paper §6.3 verbatim)
# ---------------------------------------------------------------------------

def explore_floorplans(graph: TaskGraph, grid: SlotGrid, *,
                       utils: tuple[float, ...] = DEFAULT_UTILS,
                       seed: int = 0,
                       model: PhysicalModel | None = None,
                       score: Callable[[Plan], TimingReport] | None = None,
                       sim_firings: int | None = None,
                       device="cuda",
                       **ab_kwargs) -> list[Candidate]:
    """Single-axis max-util sweep: one candidate per util point, in sweep
    order, infeasible points kept as failed candidates (paper Table 10).
    Thin wrapper over ``explore_design_space`` with every other axis pinned
    to its default (``device`` as there)."""
    model = model or PhysicalModel()
    space = SearchSpace(seeds=(seed,), utils=tuple(utils))
    res = explore_design_space(graph, grid, space=space, model=model,
                               score=score, sim_firings=sim_firings,
                               device=device, **ab_kwargs)
    return res.candidates


def best_candidate(cands: list[Candidate]) -> Candidate:
    ok = [c for c in cands
          if c.plan is not None and c.report and c.report.routed
          and (c.sim is None or not c.sim.deadlocked)]
    if not ok:
        raise InfeasibleError("no routable floorplan candidate")
    return max(ok, key=lambda c: c.report.fmax_mhz)
