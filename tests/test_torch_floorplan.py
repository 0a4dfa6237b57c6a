"""The port's co-optimization flow (``repro_torch.core``: ``floorplan``,
``assign_pipelining``, ``balance_graph``, ``analyze_timing``,
``packed_placement`` and ``autobridge``) against the reference's, in one
process, and the golden plans ``chip_smoke.py`` holds the port to on the
card.

* ``packed_placement`` + ``analyze_timing`` (the baseline flow) on all 48
  (design, board) rows of ``autobridge_suite()`` + ``hbm_suite()``;
* ``floorplan`` (placement, cost, ``iteration_stats`` with the ``exact``
  flags, ``slot_loads``) under each split order, co-location groups and
  the exact branch-and-bound, and ``assign_pipelining``;
* ``autobridge`` at the first feasible util of ``UTIL_SWEEP`` on every row
  but cnn_13x14 and cnn_13x16 (tens of seconds each): the whole ``Plan``
  and both timing reports, the reference's at the util of
  ``tests/torch_coopt_golden.json``, and both records equal to the file's
  (the reference's whole sweep of all 48 rows under ``-m slow``);
* the feedback loop (a pipelined cycle co-located, ``feedback_rounds`` 1)
  and its last resort (a cycle too big for a slot: a stream demoted to
  control), ``check=True`` on a graph the structure pass rejects, the
  ``FloorplanCache`` (hits, misses, ``merge``, conflicts, cached verdicts,
  ``initial_floorplan_key``), the ``floorplan``/``ilp`` counters and the
  ``floorplan.ilp`` span, and ``verify_throughput(device="cpu")`` against
  the reference's ``verify_throughput()``.

The golden file is written from the reference by

    PYTHONPATH=src python tests/test_torch_floorplan.py --write

Each row holds the chosen util (null where no util of the sweep is
feasible), digests of the placement and the depths, ``floorplan.cost``,
the per-iteration ``exact`` flags, ``feedback_rounds``, ``co_located``,
``demoted_streams`` and the baseline's and TAPA's ``fmax_mhz``, ``routed``
and ``fail_reason``; ``chip_smoke.py`` builds the same record with the
same digests.
"""
import dataclasses
import hashlib
import json
import pathlib
import sys

import pytest
from _torch_sim import port_graph, port_obs_isolation

import repro.core as rcore
import repro_torch.core as pcore
from repro.fpga import benchmarks as rbench, grid_for as rgrid
from repro_torch.fpga import benchmarks as pbench, grid_for as pgrid

assert port_obs_isolation  # the autouse fixture, imported to apply here

GOLDEN = pathlib.Path(__file__).with_name("torch_coopt_golden.json")
#: ``benchmarks/fmax_suite.py``'s utilization sweep
UTIL_SWEEP = (0.70, 0.75, 0.80, 0.85, 0.90, 0.95, 1.0)
#: rows whose sweep takes the reference tens of seconds (slow test only)
SLOW_DESIGNS = ("cnn_13x14", "cnn_13x16")

_RROWS = rbench.autobridge_suite() + rbench.hbm_suite()
_PROWS = pbench.autobridge_suite() + pbench.hbm_suite()
_IDS = [f"{n}-{b}" for n, b, _ in _RROWS]
_FAST = [i for i, (n, _, _) in enumerate(_RROWS) if n not in SLOW_DESIGNS]


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


def _timing(rep):
    return [rep.fmax_mhz, rep.routed, rep.fail_reason]


def coopt_flow(core, grid_for, name, board, graph, utils=UTIL_SWEEP):
    """The baseline flow and TAPA's at the first feasible util of
    ``utils``, as ``chip_smoke.py``'s ``coopt`` phase runs them.  Returns
    the golden record, the plan (None if no util is feasible) and both
    timing reports."""
    grid = grid_for(board)
    base = core.analyze_timing(graph, grid, core.packed_placement(graph, grid))
    rec = {"name": name, "board": board, "util": None,
           "base": _timing(base)}
    for u in utils:
        try:
            plan = core.autobridge(graph, grid, max_util=u)
        except core.InfeasibleError:
            continue
        opt = core.analyze_timing(graph, grid, plan.floorplan.placement,
                                  plan.depth)
        rec.update(
            util=u,
            placement=_digest(sorted(plan.floorplan.placement.items())),
            depth=_digest(sorted(plan.depth.items())),
            cost=plan.floorplan.cost,
            exact=[st["exact"] for st in plan.floorplan.iteration_stats],
            feedback_rounds=plan.feedback_rounds,
            co_located=sorted(sorted(g) for g in plan.co_located),
            demoted_streams=plan.demoted_streams,
            tapa=_timing(opt))
        return rec, plan, base, opt
    return rec, None, base, None


def _stats(fp):
    return [{k: v for k, v in st.items() if k != "wall_s"}
            for st in fp.iteration_stats]


def _floorplan_data(fp):
    return (fp.placement, fp.cost, _stats(fp), fp.max_util, fp.slot_loads,
            fp.utilization(), dataclasses.asdict(fp.grid))


def _plan_data(plan):
    """Everything a ``Plan`` holds, as plain data (``wall_s`` left out)."""
    pa, bal = plan.pipelining, plan.balancing
    return (_floorplan_data(plan.floorplan),
            (pa.lat, pa.extra_depth, pa.reg_area),
            (bal.balance, bal.potentials, bal.overhead, bal.objective),
            plan.depth, plan.area_overhead, plan.feedback_rounds,
            [sorted(g) for g in plan.co_located], plan.demoted_streams,
            plan.summary(), plan.sim_extra_capacity,
            [s.control for s in plan.graph.streams])


def _report(rep):
    return None if rep is None else dataclasses.asdict(rep)


# ---- the baseline flow and the timing model -------------------------------

@pytest.mark.parametrize("row", range(len(_RROWS)), ids=_IDS)
def test_baseline_flow_equals_the_reference(row):
    """``packed_placement`` and ``analyze_timing`` on every row, plain and
    with the pipelining of the packed placement, inserted buffer bits and a
    tighter physical model."""
    (_, board, rg), (_, _, pg) = _RROWS[row], _PROWS[row]
    rgd, pgd = rgrid(board), pgrid(board)
    rpl, ppl = rcore.packed_placement(rg, rgd), pcore.packed_placement(pg, pgd)
    assert (ppl.slots, ppl.straddle) == (rpl.slots, rpl.straddle)
    lat = {s.name: rgd.crossing_depth(rpl.slots[s.src], rpl.slots[s.dst])
           for s in rg.streams}
    bits = {s.name: 64.0 * s.width * (i % 3) for i, s in enumerate(rg.streams)}
    for kw in ({}, {"pipeline_lat": lat}, {"buffer_bits": bits}):
        assert _report(pcore.analyze_timing(pg, pgd, ppl, **kw)) == \
            _report(rcore.analyze_timing(rg, rgd, rpl, **kw))
    want = rcore.analyze_timing(rg, rgd, rpl.slots, lat, rcore.PhysicalModel(
        alpha_ns=3.5, dense_design_frac=0.3, hbm_row_util=0.8))
    got = pcore.analyze_timing(pg, pgd, ppl.slots, lat, pcore.PhysicalModel(
        alpha_ns=3.5, dense_design_frac=0.3, hbm_row_util=0.8))
    assert _report(got) == _report(want)


# ---- floorplan and pipelining ---------------------------------------------

#: rows and a feasible util of each
_FP_ROWS = {"stencil_x4-u250": 0.75, "stencil_x8-u280": 0.95,
            "cnn_13x4-u280": 0.8, "bucket_sort-u280": 0.75,
            "page_rank-u280": 0.75}


@pytest.mark.parametrize("name", _FP_ROWS)
def test_floorplan_once_each_split_order_equals_the_reference(name):
    """``_floorplan_once`` under each split order, with a co-location group,
    with the exact branch-and-bound (up to 22 free tasks, 60 s deadline)
    and with the heuristic alone."""
    row = _IDS.index(name)
    (_, board, rg), (_, _, pg) = _RROWS[row], _PROWS[row]
    rgd, pgd = rgrid(board), pgrid(board)
    group = [set(list(rg.tasks)[1:4])]
    from repro.core.floorplan import _floorplan_once as rfp
    from repro_torch.core.floorplan import _floorplan_once as pfp
    for dim_order, same_slot, threshold in (
            ("auto", [], 22), ("col_first", [], 22), ("row_first", group, 22),
            ("auto", group, 0)):
        outs = []
        for fp, g, grid in ((rfp, rg, rgd), (pfp, pg, pgd)):
            try:
                res = fp(g, grid, max_util=_FP_ROWS[name],
                         same_slot=same_slot, seed=3,
                         exact_threshold=threshold, n_starts=8,
                         time_limit_s=60.0, dim_order=dim_order)
                outs.append(_floorplan_data(res))
            except (rcore.InfeasibleError, pcore.InfeasibleError) as err:
                outs.append(("infeasible", str(err)))
        assert outs[1] == outs[0]


@pytest.mark.parametrize("name", _FP_ROWS)
def test_floorplan_and_pipelining_equal_the_reference(name):
    row = _IDS.index(name)
    (_, board, rg), (_, _, pg) = _RROWS[row], _PROWS[row]
    rgd, pgd = rgrid(board), pgrid(board)
    rfp = rcore.floorplan(rg, rgd, max_util=_FP_ROWS[name])
    pfp = pcore.floorplan(pg, pgd, max_util=_FP_ROWS[name])
    assert _floorplan_data(pfp) == _floorplan_data(rfp)
    assert pfp.crossings(pg) == rfp.crossings(rg)
    rpa, ppa = (rcore.assign_pipelining(rg, rfp),
                pcore.assign_pipelining(pg, pfp))
    assert (ppa.lat, ppa.extra_depth, ppa.reg_area) == \
        (rpa.lat, rpa.extra_depth, rpa.reg_area)


def test_infeasible_floorplan_raises_the_same_error():
    row = _IDS.index("cnn_13x16-u280")
    (_, board, rg), (_, _, pg) = _RROWS[row], _PROWS[row]
    errs = []
    for core, g, grid in ((rcore, rg, rgrid(board)), (pcore, pg, pgrid(board))):
        with pytest.raises(core.InfeasibleError) as info:
            core.floorplan(g, grid, max_util=0.6, retries=1)
        errs.append(str(info.value))
    assert errs[1] == errs[0]


# ---- the whole flow on the suite, and the golden file ---------------------

def _golden():
    return {(r["name"], r["board"]): r for r in json.loads(GOLDEN.read_text())}


@pytest.mark.parametrize("row", _FAST, ids=[_IDS[i] for i in _FAST])
def test_autobridge_plan_equals_the_reference_and_the_golden_file(row):
    """The port's sweep finds the golden file's util and plan; the
    reference, run at that util only (its whole sweep is the slow test's),
    gives the golden record too, and the same ``Plan`` and timing reports
    as the port."""
    (name, board, rg), (_, _, pg) = _RROWS[row], _PROWS[row]
    golden = _golden()[(name, board)]
    got, pplan, pbase, popt = coopt_flow(pcore, pgrid, name, board, pg)
    want, rplan, rbase, ropt = coopt_flow(rcore, rgrid, name, board, rg,
                                          utils=(golden["util"],))
    assert want == golden
    assert got == want
    assert (_report(pbase), _report(popt)) == (_report(rbase), _report(ropt))
    assert (pplan is None) == (rplan is None)
    if rplan is not None:
        assert _plan_data(pplan) == _plan_data(rplan)


@pytest.mark.slow
@pytest.mark.parametrize("row", range(len(_RROWS)), ids=_IDS)
def test_golden_file_equals_the_reference_on_every_row(row):
    name, board, rg = _RROWS[row]
    assert coopt_flow(rcore, rgrid, name, board, rg)[0] == \
        _golden()[(name, board)]


def test_golden_file_covers_the_suite():
    rows = json.loads(GOLDEN.read_text())
    assert [(r["name"], r["board"]) for r in rows] == \
        [(n, b) for n, b, _ in _RROWS]
    infeasible = [(r["name"], r["board"]) for r in rows if r["util"] is None]
    assert infeasible == [("cnn_13x16", "u280")]


# ---- the feedback loop, its last resort, and check=True ------------------

def _cycle_graph(core, big):
    """X (pinned top) -> A <-> B -> Y (pinned bottom) on a two-slot grid:
    the wide X->A and B->Y streams pull A and B apart, so the narrow A <-> B
    cycle crosses the boundary and is pipelined.  With ``big`` A and B
    cannot share a slot, so co-locating them is infeasible."""
    area = 60.0 if big else 10.0
    g = core.TaskGraph("cycle")
    g.add_task(core.Task("X", {"LUT": 10.0}, pinned=(0, 0)))
    g.add_task(core.Task("A", {"LUT": area}))
    g.add_task(core.Task("B", {"LUT": area}))
    g.add_task(core.Task("Y", {"LUT": 10.0}, pinned=(1, 0)))
    for name, src, dst, width in (("xa", "X", "A", 100.0),
                                  ("ab", "A", "B", 1.0),
                                  ("ba", "B", "A", 0.5),
                                  ("by", "B", "Y", 100.0)):
        g.add_stream(core.Stream(name, src, dst, width=width))
    grid = core.SlotGrid("two", rows=2, cols=1,
                         base_capacity={"LUT": 100.0}, max_util=1.0)
    return g, grid


@pytest.mark.parametrize("big", [False, True], ids=["co-locate", "demote"])
def test_feedback_loop_equals_the_reference(big):
    plans = []
    for core in (rcore, pcore):
        g, grid = _cycle_graph(core, big)
        plans.append(core.autobridge(g, grid))
    assert _plan_data(plans[1]) == _plan_data(plans[0])
    plan = plans[1]
    if big:
        assert plan.feedback_rounds == 2 and plan.demoted_streams == ["ba"]
        assert plan.co_located == []
    else:
        assert plan.feedback_rounds == 1 and plan.demoted_streams == []
        assert plan.co_located == [{"A", "B"}]
        assert plan.floorplan.placement["A"] == plan.floorplan.placement["B"]


def test_feedback_limit_raises_the_same_error():
    errs = []
    for core in (rcore, pcore):
        g, grid = _cycle_graph(core, False)
        with pytest.raises(core.InfeasibleError) as info:
            core.autobridge(g, grid, max_feedback=0)
        errs.append(str(info.value))
    assert errs[1] == errs[0]
    assert "could not break pipelined cycle" in errs[1]


def _malformed(core):
    """A self-loop and a stream of width 0: errors of the structure pass."""
    g = core.TaskGraph("malformed")
    g.add_task(core.Task("P", {"LUT": 1.0}))
    g.add_task(core.Task("C", {"LUT": 1.0}))
    g.add_stream(core.Stream("pc", "P", "C"))
    g.add_stream(core.Stream("pp", "P", "P"), validate=False)
    g.add_stream(core.Stream("w0", "P", "C", width=0.0), validate=False)
    return g


def test_check_rejects_the_same_graph_with_the_same_text():
    from repro.analysis import analysis_counts as rcounts
    from repro_torch.analysis import analysis_counts as pcounts
    errs = []
    for core, grid_for, counts in ((rcore, rgrid, rcounts),
                                   (pcore, pgrid, pcounts)):
        cache = core.FloorplanCache()
        g, grid = _malformed(core), grid_for("u250")
        for _ in range(2):
            with pytest.raises(core.InfeasibleError) as info:
                core.autobridge(g, grid, check=True, cache=cache)
            errs.append(str(info.value))
        # the second call is answered by the cached verdict
        errs.append((counts()["infeasible"], len(cache), cache.stats()))
    assert errs[3:] == errs[:3]
    assert errs[0].startswith("static analysis")


# ---- FloorplanCache, counters and the span ------------------------------

def _cache_run(core, grid_for, graph):
    from importlib import import_module
    trace = import_module(core.__name__.split(".")[0] + ".obs.trace")
    core.reset_floorplan_counts()
    trace.enable(clear=True)
    grid = grid_for("u280")
    a, b = core.FloorplanCache(), core.FloorplanCache()
    p1 = core.autobridge(graph, grid, max_util=0.75, cache=a)
    p2 = core.autobridge(graph, grid, max_util=0.75, cache=a)
    with pytest.raises(core.InfeasibleError):
        core.autobridge(graph, grid, max_util=0.3, cache=b)
    core.autobridge(graph, grid, max_util=0.8, cache=b)
    key = core.initial_floorplan_key(graph, grid, max_util=0.75)
    out = {"same_plan": _plan_data(p1) == _plan_data(p2),
           "stats": (a.stats(), b.stats()),
           "key_in": (key in a, key in b),
           "cached_error": b.cached_error(
               core.initial_floorplan_key(graph, grid, max_util=0.3)),
           "merge": a.merge(b), "merge_again": a.merge(b),
           "after": (len(a), a.merge_conflicts)}
    # a conflicting value under a key both hold
    c = core.FloorplanCache()
    c._put(key, ("ok", dataclasses.replace(a._lookup(key)[1], cost=-1.0)))
    out["conflicts"] = (a.merge(c), a.merge_conflicts)
    c.record_infeasible(("k",), "static analysis: x")
    c.record_infeasible(("k",), "static analysis: y")
    out["recorded"] = c.cached_error(("k",))
    out["counts"] = core.floorplan_counts()
    trace.disable()
    out["spans"] = [(e["name"], e["args"]) for e in trace.drain()
                    if e["name"] == "floorplan.ilp"]
    core.merge_floorplan_counts({"solved": 2, "cache_hits": 1,
                                 "ilp_bipartitions": 5})
    out["merged"] = core.floorplan_counts()
    return out, key


def test_floorplan_cache_counters_and_span_equal_the_reference():
    row = _IDS.index("bucket_sort-u280")
    want, rkey = _cache_run(rcore, rgrid, _RROWS[row][2])
    got, pkey = _cache_run(pcore, pgrid, _PROWS[row][2])
    assert got == want
    assert pkey == rkey
    assert got["stats"] == ({"entries": 1, "hits": 1, "misses": 1},
                            {"entries": 2, "hits": 0, "misses": 2})
    assert got["counts"]["cache_hits"] == 1 and got["counts"]["solved"] == 3
    assert got["counts"]["merge_conflicts"] == 1
    assert got["spans"][-1][1].get("infeasible") is None
    assert any(args.get("infeasible") for _, args in got["spans"])


def test_counters_live_on_the_port_registry():
    from repro_torch.obs import metrics
    pcore.reset_floorplan_counts()
    g, grid = _cycle_graph(pcore, False)
    pcore.autobridge(g, grid)
    snap = metrics.REGISTRY.snapshot()
    assert snap["floorplan"]["values"] == {"solved": 2, "cache_hits": 0,
                                           "merge_conflicts": 0}
    assert snap["ilp"]["values"]["bipartitions"] == \
        pcore.floorplan_counts()["ilp_bipartitions"] > 0


# ---- the throughput check ----------------------------------------------

@pytest.mark.parametrize("name", ["bucket_sort-u280", "page_rank-u280",
                                  "cnn_13x2-u250"])
def test_verify_throughput_on_cpu_equals_the_reference(name):
    row = _IDS.index(name)
    (_, board, rg), (_, _, pg) = _RROWS[row], _PROWS[row]
    rplan = rcore.autobridge(rg, rgrid(board), max_util=0.75)
    pplan = pcore.autobridge(pg, pgrid(board), max_util=0.75)
    want = rplan.verify_throughput()
    got = pplan.verify_throughput(device="cpu")
    key = lambda r: (r.cycles, r.fired, r.deadlocked, r.steps)  # noqa: E731
    assert [key(r) for r in got] == [key(r) for r in want]
    base, opt = got
    assert not opt.deadlocked
    assert opt.cycles - base.cycles <= sum(pplan.depth.values()) + pg.num_tasks
    job = pplan.sim_job()
    assert (job.latency, job.extra_capacity) == \
        (rplan.sim_job().latency, rplan.sim_job().extra_capacity)


def test_verify_throughput_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    g = port_graph(_RROWS[_IDS.index("bucket_sort-u280")][2])
    plan = pcore.autobridge(g, pgrid("u280"), max_util=0.75)
    with pytest.raises(RuntimeError):
        plan.verify_throughput()


def _write_golden():
    rows = [coopt_flow(rcore, rgrid, n, b, g)[0] for n, b, g in _RROWS]
    GOLDEN.write_text("[\n" + ",\n".join(json.dumps(r) for r in rows)
                      + "\n]\n")
    print(f"wrote {len(rows)} rows to {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_floorplan.py "
                 "--write")
    _write_golden()
