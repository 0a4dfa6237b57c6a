"""Differential fuzz driver: every generated design through the full
pipeline, every stage cross-checked against an independent oracle.

The oracle table (``docs/corpus-guide.md`` renders the reference's, whose
third row is its jax backend):

=====================  ===========================  ======================
stage                  oracle                       checked property
=====================  ===========================  ======================
``analysis.analyze``   event-engine simulation      deadlock verdict exact
                                                    (both directions),
                                                    ``min_cycles`` and
                                                    firing bounds hold
``simulate_batch``     per-job event engine         numpy padded batch ==
                                                    event on (cycles,
                                                    fired, deadlocked)
torch backend          numpy padded batch           bit-identical incl.
(``device``)                                        ``steps``
``autobridge``         static pre-flight + solver   feasible designs plan,
                                                    broken designs raise
                                                    ``InfeasibleError``
                                                    (both paths taken)
search (``jobs=N``)    the sequential ``jobs=1``    frontier bit-identical
                       run
search (surrogate)     the uniform proposer         converges in <= rounds
                                                    at >= hypervolume
=====================  ===========================  ======================

``run_differential`` executes the table over a design list and returns a
``DifferentialReport`` whose counters the bench suite serializes into
``BENCH_corpus.json``; any mismatch is a recorded string, and ``ok`` is
the corpus gate's pass/fail bit.

Counterpart of ``repro.corpus.differential``.  The torch row always runs,
on ``run_differential``'s ``device`` (default ``"cuda"``: the
``sim_sweep`` kernel; ``"cpu"``: its plain version), and counts
``torch_checked`` where the reference counts ``jax_checked``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import InfeasibleError, simulate, simulate_batch
from repro_torch.core.autobridge import FloorplanCache, autobridge
from repro_torch.core.devicegrid import SlotGrid
from repro_torch.core.simulate import _sweep_device
from repro_torch.analysis import analyze
from repro_torch.search.engine import explore_design_space, search_until_converged
from repro_torch.search.pareto import objective_vector
from repro_torch.search.space import SearchSpace

from .generator import CorpusDesign

#: event-engine budget per design (generated waves are small; a run that
#: needs more cycles than this is a bug, not a slow design)
_MAX_CYCLES = 500_000


def _default_grid() -> SlotGrid:
    from repro_torch.fpga import u280_grid
    return u280_grid()


@dataclasses.dataclass
class DifferentialReport:
    """Counters + mismatch strings of one differential run."""
    designs: int = 0
    families: dict[str, int] = dataclasses.field(default_factory=dict)
    #: stage 1 — analysis verdicts vs the event engine
    verdicts_checked: int = 0
    #: stage 2 — padded numpy batch vs per-job event
    sims_checked: int = 0
    #: stage 2b — the torch sweep on the run's device vs numpy
    torch_checked: int = 0
    #: stage 3 — autobridge outcomes
    feasible: int = 0
    infeasible: int = 0
    #: stage 4 — parallel-search frontier identity
    searches_checked: int = 0
    #: stage 5 — surrogate-vs-uniform convergence
    surrogate_checked: int = 0
    mismatches: list[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def counters(self) -> dict:
        """JSON-able summary (what ``BENCH_corpus.json`` embeds)."""
        out = dataclasses.asdict(self)
        out["ok"] = self.ok
        return out

    def _flag(self, design: CorpusDesign, stage: str, msg: str) -> None:
        self.mismatches.append(
            f"[{stage}] {design.name} fp={design.fingerprint}: {msg}")


def _check_verdicts(designs, rep: DifferentialReport) -> list:
    """Stage 1: exact analysis verdicts per design, at the design's own
    wave size.  Returns each design's event result for reuse."""
    results = []
    for d in designs:
        a = analyze(d.graph, latency=d.latency,
                    extra_capacity=d.extra_capacity, ii=d.ii,
                    firings=d.firings)
        ev = simulate(d.graph, engine="event", firings=d.firings,
                      latency=d.latency, extra_capacity=d.extra_capacity,
                      ii=d.ii, max_cycles=_MAX_CYCLES)
        rep.verdicts_checked += 1
        if a.deadlock != ev.deadlocked:
            rep._flag(d, "analysis",
                      f"static deadlock={a.deadlock} vs engine "
                      f"{ev.deadlocked} ({[str(x) for x in a.diagnostics]})")
        if not ev.deadlocked and a.min_cycles is not None \
                and ev.cycles < a.min_cycles:
            rep._flag(d, "analysis",
                      f"engine ran {ev.cycles} cycles under static bound "
                      f"{a.min_cycles}")
        for n, bound in a.max_firings.items():
            if bound is not None and ev.fired[n] > bound:
                rep._flag(d, "analysis",
                          f"task {n} fired {ev.fired[n]} > bound {bound}")
        results.append(ev)
    return results


def _check_backends(designs, rep: DifferentialReport, *,
                    firings: int, device) -> None:
    """Stage 2: one padded numpy sweep over ALL designs vs per-job event,
    plus the torch sweep on ``device`` vs numpy, bit-identical."""
    jobs = [d.sim_job() for d in designs]
    np_res = simulate_batch(jobs, firings=firings, backend="numpy",
                            device=device)
    ev_res = simulate_batch(jobs, firings=firings, backend="event",
                            device=device)
    for d, a, b in zip(designs, np_res, ev_res):
        rep.sims_checked += 1
        if (a.cycles, a.fired, a.deadlocked) != \
                (b.cycles, b.fired, b.deadlocked):
            rep._flag(d, "sim", f"numpy {a.cycles}/{a.deadlocked} vs "
                                f"event {b.cycles}/{b.deadlocked}")
    th_res = simulate_batch(jobs, firings=firings, backend="torch",
                            device=device)
    for d, a, b in zip(designs, th_res, np_res):
        rep.torch_checked += 1
        if (a.cycles, a.fired, a.deadlocked, a.steps) != \
                (b.cycles, b.fired, b.deadlocked, b.steps):
            rep._flag(d, "torch", f"torch {a.cycles}/{a.deadlocked}/"
                                  f"{a.steps} vs numpy {b.cycles}/"
                                  f"{b.deadlocked}/{b.steps}")


def _check_floorplans(designs, rep: DifferentialReport, *,
                      grid: SlotGrid, limit: int) -> None:
    """Stage 3: autobridge with the static pre-flight on.  Clean designs
    must produce a plan; broken ones must raise — never crash.  The
    budget is spent round-robin across families so both the feasible and
    the infeasible (fuzz: zero-capacity FIFOs, data cycles) paths run."""
    by_family: dict[str, list] = {}
    for d in designs:
        by_family.setdefault(d.family, []).append(d)
    picked: list = []
    rank = 0
    while len(picked) < min(limit, len(designs)):
        layer = [ds[rank] for ds in by_family.values() if rank < len(ds)]
        if not layer:
            break
        picked.extend(layer)
        rank += 1
    cache = FloorplanCache()
    for d in picked[:limit]:
        try:
            plan = autobridge(d.graph, grid, check=True, cache=cache)
        except InfeasibleError:
            rep.infeasible += 1
            continue
        rep.feasible += 1
        if plan.floorplan is None:
            rep._flag(d, "autobridge", "feasible but no floorplan")


def _check_search_identity(designs, rep: DifferentialReport, *,
                           grid: SlotGrid, jobs: int, device) -> None:
    """Stage 4: parallel explore == sequential explore, frontier
    bit-identical (points and objective vectors)."""
    space = SearchSpace(seeds=(0,), utils=(0.6, 0.8), depth_scales=(1.0, 2.0))
    for d in designs:
        seq = explore_design_space(d.graph, grid, space=space,
                                   sim_firings=d.firings, jobs=1,
                                   device=device)
        par = explore_design_space(d.graph, grid, space=space,
                                   sim_firings=d.firings, jobs=jobs,
                                   device=device)
        rep.searches_checked += 1
        fp_seq = [(dataclasses.astuple(c.point), objective_vector(c))
                  for c in seq.frontier]
        fp_par = [(dataclasses.astuple(c.point), objective_vector(c))
                  for c in par.frontier]
        if fp_seq != fp_par:
            rep._flag(d, "search",
                      f"jobs={jobs} frontier differs from jobs=1: "
                      f"{fp_par} vs {fp_seq}")


def _check_surrogate(design, rep: DifferentialReport, *,
                     grid: SlotGrid, device) -> None:
    """Stage 5: the surrogate proposer must not converge slower or lower
    than the uniform one on the same budget."""
    kw = dict(space=SearchSpace(utils=(0.55, 0.65, 0.75, 0.85)),
              rounds=3, points_per_round=8, sim_firings=design.firings,
              device=device)
    uni = search_until_converged(design.graph, grid, **kw)
    sur = search_until_converged(design.graph, grid, proposer="surrogate",
                                 **kw)
    rep.surrogate_checked += 1
    if sur.rounds_run > uni.rounds_run:
        rep._flag(design, "surrogate",
                  f"{sur.rounds_run} rounds > uniform {uni.rounds_run}")
    hv_uni = uni.hypervolumes[-1] if uni.hypervolumes else 0.0
    hv_sur = sur.hypervolumes[-1] if sur.hypervolumes else 0.0
    if hv_sur < hv_uni - 1e-9:
        rep._flag(design, "surrogate",
                  f"hypervolume {hv_sur} < uniform {hv_uni}")


def run_differential(designs: list[CorpusDesign], *,
                     grid: SlotGrid | None = None,
                     sim_firings: int = 25,
                     floorplan_limit: int = 24,
                     search_designs: int = 0,
                     search_jobs: int = 2,
                     check_surrogate: bool = False,
                     device="cuda") -> DifferentialReport:
    """The full differential table over ``designs``.

    Stages 1-2 (analysis verdicts, backend equivalence) run over every
    design; stage 3 (autobridge) over the first ``floorplan_limit``;
    stage 4 (parallel-search identity) over the first ``search_designs``
    *feasible-family* designs (those with non-empty areas); stage 5
    (surrogate convergence) over the first such design when
    ``check_surrogate`` is set.  ILP-heavy stages are opt-in by budget so
    tier-1 tests stay fast while the bench suite runs the whole table.
    Every simulator call runs on ``device`` (default ``"cuda"``), checked
    before any work: without a card a call that did not pass
    ``device="cpu"`` raises ``RuntimeError``.
    """
    _sweep_device(device)
    grid = grid or _default_grid()
    rep = DifferentialReport(designs=len(designs))
    for d in designs:
        rep.families[d.family] = rep.families.get(d.family, 0) + 1

    _check_verdicts(designs, rep)
    _check_backends(designs, rep, firings=sim_firings, device=device)
    _check_floorplans(designs, rep, grid=grid, limit=floorplan_limit)

    searchable = [d for d in designs
                  if all(t.area for t in d.graph.tasks.values())]
    if search_designs:
        _check_search_identity(searchable[:search_designs], rep,
                               grid=grid, jobs=search_jobs, device=device)
    if check_surrogate and searchable:
        _check_surrogate(searchable[0], rep, grid=grid, device=device)
    return rep
