"""Shared inputs of the ``test_torch_sim_*`` parity tests: the same graphs
and jobs built in the reference package ``repro`` and in the port
``repro_torch``, from numpy / ``random`` seeds, and the port's obs
isolation."""
import dataclasses
import random

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as pcore
from repro.corpus import random_graph

def port_graph(g):
    """A reference ``TaskGraph`` rebuilt as the port's, field for field."""
    out = pcore.TaskGraph(g.name)
    for t in g.tasks.values():
        out.add_task(pcore.Task(**dataclasses.asdict(t)))
    for s in g.streams:
        out.add_stream(pcore.Stream(**dataclasses.asdict(s)), validate=False)
    return out


def port_job(j):
    return pcore.SimJob(port_graph(j.graph), latency=j.latency,
                        extra_capacity=j.extra_capacity, ii=j.ii)


def key(r):
    """What every engine must agree on, bit for bit."""
    return r.cycles, r.fired, r.deadlocked, r.steps


def random_mixed_jobs(seed: int, n=(2, 6)):
    """Reference ``SimJob``s over independent random topologies (cycles,
    detached sinks, control streams, zero-capacity FIFOs) with random
    latency, headroom and II knobs, as ``tests/test_simulate_event.py``
    draws them."""
    rng = random.Random(seed)
    jobs = []
    for _ in range(rng.randint(*n)):
        g = random_graph(rng, allow_cycle=True)
        lat = {s.name: rng.randint(0, 4) for s in g.streams}
        extra = {s.name: rng.choice([0, 0, 2, 2 * lat[s.name]])
                 for s in g.streams}
        ii = {t: rng.randint(1, 4) for t in g.tasks}
        jobs.append(rcore.SimJob(g, latency=lat, extra_capacity=extra, ii=ii))
    return jobs


def _chain(core, name, depth, control=False, detached=False):
    g = core.TaskGraph(name)
    g.add_task(core.Task("P"))
    g.add_task(core.Task("C", detached=detached))
    g.add_stream(core.Stream(name="s", src="P", dst="C", width=8,
                             depth=depth, control=control), validate=False)
    return g


def _loop(core, name, control):
    """The tokenless two-task loop of ``repro.analysis``'s doctest; closed
    through a control stream it is safe."""
    b = core.TaskGraphBuilder(name)
    b.stream("ab")
    b.stream("ba", control=control)
    b.invoke("A", ins=["ba"], outs=["ab"])
    b.invoke("B", ins=["ab"], outs=["ba"])
    return b.build()


def _lonely(core, name, n):
    """Tasks with no stream at all."""
    g = core.TaskGraph(name)
    for i in range(n):
        g.add_task(core.Task(f"T{i}"))
    return g


def _fork(core, name):
    """A producer feeding a consumer and a detached monitor."""
    b = core.TaskGraphBuilder(name)
    b.stream("a", depth=2)
    b.stream("m", depth=1)
    b.invoke("P", outs=["a", "m"])
    b.invoke("C", ins=["a"])
    b.invoke("Mon", ins=["m"], detach=True)
    return b.build()


def edge_jobs(core, long_latency=None):
    """The edge cases the kernel is held to, as ``core``'s jobs: a
    producer-consumer with II > 1 and latency, a zero-capacity FIFO
    (deadlock), the tokenless loop (deadlock) and its control-closed twin,
    control-only and stream-less graphs, detached tasks, and (when
    ``long_latency`` is given) a stream whose latency makes a deep ring."""
    J = core.SimJob
    jobs = [
        J(_chain(core, "pc", 2), latency={"s": 3},
          extra_capacity={"s": 6}, ii={"C": 2}),
        J(_chain(core, "pc", 2), ii={"P": 3}),
        J(_chain(core, "zero", 0), latency={"s": 1}),
        J(_loop(core, "loop", control=False)),
        J(_loop(core, "loop2", control=True)),
        J(_chain(core, "ctl", 2, control=True)),
        J(_chain(core, "det", 1, detached=True), latency={"s": 2}),
        J(_lonely(core, "solo", 3), ii={"T1": 4}),
        J(_fork(core, "fork"), latency={"a": 2, "m": 1}),
    ]
    if long_latency:
        jobs.append(J(_chain(core, "deep", 2), latency={"s": long_latency},
                      extra_capacity={"s": 2 * long_latency}))
    return jobs


def streamless_jobs(core):
    """A batch with no data stream at all (S* = 0)."""
    J = core.SimJob
    return [J(_lonely(core, "solo", 3), ii={"T1": 4}),
            J(_chain(core, "ctl", 2, control=True), ii={"C": 2}),
            J(_lonely(core, "one", 1))]


def paper_jobs(core, seed=0, variants=2):
    """``variants`` seeded variants of each (design, device) row of the
    paper's suites: latency 0-4 on ~30 % of the data streams,
    ``pipeline_headroom`` as extra capacity, II = 2 on ~5 % of the
    tasks."""
    from importlib import import_module
    bench = import_module(core.__name__.split(".")[0] + ".fpga.benchmarks")
    rng = np.random.default_rng(seed)
    jobs = []
    for _name, _board, g in bench.autobridge_suite() + bench.hbm_suite():
        data = [s.name for s in g.streams if not s.control]
        for _ in range(variants):
            lat = {s: int(rng.integers(0, 5)) for s in data
                   if rng.random() < 0.3}
            ii = {t: 2 for t in g.tasks if rng.random() < 0.05}
            jobs.append(core.SimJob(
                g, latency=lat, extra_capacity=core.pipeline_headroom(lat),
                ii=ii))
    return jobs


@pytest.fixture(autouse=True)
def port_obs_isolation():
    """The port's own registry and trace buffer, restored after each test
    (``conftest.py`` isolates the reference's)."""
    from repro_torch.obs import metrics, trace

    snap = metrics.snapshot()
    was_enabled = trace.enabled()
    saved = trace.drain()
    try:
        yield
    finally:
        metrics.restore(snap)
        trace.clear()
        trace.attach("")
        if was_enabled:
            trace.enable()
        else:
            trace.disable()
        trace.absorb(saved)


# ---- the design-space search (``test_torch_search*.py``) ------------------

#: ``benchmarks/fmax_suite.py``'s utilization sweep, fast subset, firings
#: and converged-mode budget
UTIL_SWEEP = (0.70, 0.75, 0.80, 0.85, 0.90, 0.95, 1.0)
FAST_SUBSET = ("stencil_x2", "stencil_x4", "cnn_13x2", "gaussian_12",
               "bucket_sort", "page_rank")
SEARCH_FIRINGS = 200
CONVERGE_ROUNDS = 3
CONVERGE_POINTS = 12
#: the corpus batch ``chip_smoke.py`` runs: (family, designs, first seed)
CORPUS_BATCH = (("dag", 4, 500), ("cyclic", 4, 500), ("sdf", 4, 500),
                ("wide", 4, 500), ("hbm", 4, 500), ("fuzz", 6, 600))


def pkg_module(pkg: str, name: str):
    from importlib import import_module
    return import_module(f"{pkg}.{name}")


def sim_kwargs(pkg: str, key: str = "sim_backend") -> dict:
    """How each package scores a search's throughput here: the reference
    on its NumPy sweep, the port on the sweep's plain version on the CPU
    (``key`` is ``"backend"`` for the functions that take that name)."""
    if pkg == "repro":
        return {key: "numpy"}
    return {key: "torch", "device": "cpu"}


def fast_rows(pkg: str):
    """The fast subset's (design, board, graph) rows of
    ``autobridge_suite()``, in the suite's order."""
    return [r for r in pkg_module(pkg, "fpga.benchmarks").autobridge_suite()
            if r[0] in FAST_SUBSET]


def vecadd(core, pe=4):
    """``tests/test_sweeps.py``'s HBM-bound vector add."""
    b = core.TaskGraphBuilder("VecAdd")
    a = b.streams("str_a", n=pe, width=512)
    bb = b.streams("str_b", n=pe, width=512)
    c = b.streams("str_c", n=pe, width=512)
    b.invoke("LoadA", area={"LUT": 12e3, "BRAM": 30, "hbm_channels": 1},
             outs=a, count=pe)
    b.invoke("LoadB", area={"LUT": 12e3, "BRAM": 30, "hbm_channels": 1},
             outs=bb, count=pe)
    b.invoke("Add", area={"LUT": 60e3, "DSP": 256}, ins=a + bb, outs=c,
             count=pe)
    b.invoke("Store", area={"LUT": 12e3, "hbm_channels": 1}, ins=c, count=pe)
    return b.build()


def chain_graph(core, n=4, width=64, lut=100):
    """``tests/test_robustness.py``'s chain of ``n`` tasks."""
    b = core.TaskGraphBuilder("chain")
    for i in range(n - 1):
        b.stream(f"s{i}", width=width)
    for i in range(n):
        b.invoke(f"K{i}", area={"LUT": lut},
                 ins=[f"s{i - 1}"] if i > 0 else [],
                 outs=[f"s{i}"] if i < n - 1 else [])
    return b.build()


def cand_row(c):
    """(point, fmax, buffer bits, cycles, deadlock) of one candidate."""
    return [list(dataclasses.astuple(c.point)), c.fmax, c.plan.area_overhead,
            c.sim.cycles if c.sim is not None else None,
            c.sim.deadlocked if c.sim is not None else None]


def best_row(core, res):
    try:
        c = res.best
    except core.InfeasibleError:
        return None
    return [list(dataclasses.astuple(c.point)), c.fmax]


def _exact(c):
    return [st["exact"] for st in c.plan.floorplan.iteration_stats]


def default_search(pkg: str, rows, **sim):
    """The fast subset's default path as ``fmax_suite.py`` runs it: one
    ``prepare_design_space`` over ``UTIL_SWEEP`` a row, then ONE
    ``timed_pool_simulations`` over every row's jobs.  Returns each row's
    record and the call's metadata."""
    core = pkg_module(pkg, "core")
    grid_for = pkg_module(pkg, "fpga").grid_for
    space = core.SearchSpace(seeds=(0,), utils=UTIL_SWEEP)
    preps = [core.prepare_design_space(g, grid_for(b), space=space)
             for _, b, g in rows]
    _, meta = core.timed_pool_simulations(preps, firings=SEARCH_FIRINGS,
                                          **sim)
    recs = []
    for (name, board, g), prep in zip(rows, preps):
        grid = grid_for(board)
        base = core.analyze_timing(g, grid, core.packed_placement(g, grid))
        res = prep.finish(sim_calls=1)
        recs.append({
            "name": name, "board": board,
            "base_mhz": base.fmax_mhz if base.routed else 0.0,
            "space_size": res.space_size, "feasible": len(prep.feasible),
            "base_cycles": prep.base_sim.cycles,
            "frontier": [cand_row(c) for c in res.frontier],
            "exact": [_exact(c) for c in res.frontier],
            "best": best_row(core, res)})
    return recs, meta


def converged_search(pkg: str, name, board, graph, *, cache, jobs=1, **sim):
    """One row through ``search_until_converged`` as ``fmax_suite.py
    --converge`` runs it: the ``UTIL_SWEEP`` anchors, a continuous
    ``Interval(0.70, 1.0)``, 3 rounds of 12 points.  Returns the record and
    the result."""
    core = pkg_module(pkg, "core")
    grid = pkg_module(pkg, "fpga").grid_for(board)
    anchors = [core.SearchPoint(seed=0, max_util=u) for u in UTIL_SWEEP]
    res = core.search_until_converged(
        graph, grid,
        space=core.SearchSpace(utils=core.Interval(UTIL_SWEEP[0],
                                                   UTIL_SWEEP[-1])),
        rounds=CONVERGE_ROUNDS, points_per_round=CONVERGE_POINTS,
        sim_firings=SEARCH_FIRINGS, initial_points=anchors, cache=cache,
        jobs=jobs, **sim)
    every = [c for r in res.rounds for c in r.candidates
             if c.plan is not None]
    rec = {"name": name, "board": board, "rounds_run": res.rounds_run,
           "converged": res.converged,
           "points_evaluated": res.points_evaluated,
           "hypervolumes": res.hypervolumes,
           "frontier": [cand_row(c) for c in res.frontier],
           "exact": [_exact(c) for c in res.frontier],
           "inexact": sum(not e for c in every for e in _exact(c)),
           "best": best_row(core, res)}
    return rec, res


#: the reference and the port
PKGS = ("repro", "repro_torch")


def search_design(pkg, name):
    """(graph, grid): vecadd on the U280, or a design of
    ``autobridge_suite()`` on its board."""
    core = pkg_module(pkg, "core")
    fpga = pkg_module(pkg, "fpga")
    if name == "vecadd":
        return vecadd(core), fpga.u280_grid()
    _, board, g = next(r for r in fpga.benchmarks.autobridge_suite()
                       if r[0] == name)
    return g, fpga.grid_for(board)


def search_plan_rows(cands):
    """Each candidate's point, objectives, placement and depths."""
    return [cand_row(c) + [sorted(c.plan.floorplan.placement.items()),
                           sorted(c.plan.depth.items())]
            for c in cands]


def search_rows(res):
    """A ``SearchResult`` as plain data: its frontier, every candidate's
    point and feasibility, the space size and the simulator calls."""
    return (search_plan_rows(res.frontier),
            [(dataclasses.astuple(c.point), c.error is None)
             for c in res.candidates],
            res.space_size, res.sim_calls)


def corpus_designs(pkg: str):
    """``CORPUS_BATCH``'s designs."""
    corpus = pkg_module(pkg, "corpus")
    return [d for fam, n, seed in CORPUS_BATCH
            for d in corpus.sample_corpus(fam, n, seed=seed)]


#: the ``DifferentialReport`` counters both packages share
CORPUS_COUNTERS = ("designs", "families", "verdicts_checked",
                   "sims_checked", "feasible", "infeasible",
                   "searches_checked", "surrogate_checked", "mismatches")


def corpus_counters(rep) -> dict:
    return {k: getattr(rep, k) for k in CORPUS_COUNTERS}
