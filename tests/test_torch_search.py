"""The paper's §6.3 joint design-space search through the port
(``repro_torch.search``) against the reference's (``repro.search``), and
the golden file ``chip_smoke.py``'s ``search`` and ``corpus`` phases hold
the card to.

* the default path of ``benchmarks/fmax_suite.py --subset fast``: one
  ``prepare_design_space`` over ``UTIL_SWEEP`` a (design, board) row, ONE
  ``timed_pool_simulations`` over every row's jobs (the port on the
  sweep's plain version, ``backend="torch", device="cpu"``; the reference
  on its NumPy sweep); each row's frontier (point, fmax, buffer bits,
  cycles, deadlock), ``exact`` flags and best candidate;
* the converged path (``--converge``: ``UTIL_SWEEP`` anchors, a continuous
  ``Interval(0.70, 1.0)``, 3 rounds of 12 points, one shared
  ``FloorplanCache``), the port with ``jobs=2``: rounds, points,
  hypervolumes, frontier, the ``exact`` flags of the frontier and the
  count of inexact ILP iterations over every candidate (a mismatch there
  names the ILP's wall-clock deadline, not a wrong frontier);
* the corpus batch of ``chip_smoke.py`` through ``run_differential``;
* the device rule (no ``device="cpu"`` and no card: ``RuntimeError``
  before any work), the refused ``"jax"`` backend name, the renamed
  ``measure_backend_speedup`` and ``timed_pool_simulations`` fields, and
  ``repro_torch.core``'s 25 search names.

Tier-1 checks the rows the reference affords in seconds (the stencils,
bucket_sort and page_rank; two stencil rows on the converged path); ``-m
slow`` checks all ten rows of both paths.  The golden file is written from
the reference by

    PYTHONPATH=src python tests/test_torch_search.py --write
"""
import json
import pathlib
import sys

import pytest
from _torch_sim import (CORPUS_COUNTERS, FAST_SUBSET, SEARCH_FIRINGS,
                        UTIL_SWEEP, chain_graph, converged_search,
                        corpus_counters, corpus_designs, default_search,
                        fast_rows, pkg_module, port_obs_isolation,
                        sim_kwargs)

import repro.core as rcore
import repro_torch.core as pcore
import repro_torch.search as psearch

assert port_obs_isolation  # the autouse fixture, imported to apply here

GOLDEN = pathlib.Path(__file__).with_name("torch_search_golden.json")
#: rows whose search takes the reference more than a few seconds
SLOW_DESIGNS = ("cnn_13x2", "gaussian_12")
#: converged rows tier-1 affords
CONVERGED_FAST = ("stencil_x2-u250", "stencil_x4-u280")

_ROWS = fast_rows("repro")
_IDS = [f"{n}-{b}" for n, b, _ in _ROWS]
_CHEAP = [i for i, (n, _, _) in enumerate(_ROWS) if n not in SLOW_DESIGNS]


def _golden():
    return json.loads(GOLDEN.read_text())


def _rows(pkg, idx):
    rows = fast_rows(pkg)
    return [rows[i] for i in idx]


def _check_converged(got, want):
    """Exact flags first: the ILP's branch-and-bound has a wall-clock
    deadline, so a row that differs there differs for that reason."""
    assert (got["exact"], got["inexact"]) == \
        (want["exact"], want["inexact"]), \
        f"{got['name']}/{got['board']}: the ILP's exact flags differ " \
        f"(its time limit was hit on one side), so the frontiers may too"
    assert got == want


def test_golden_file_covers_the_fast_subset():
    gold = _golden()
    assert [(r["name"], r["board"]) for r in gold["default"]] == \
        [(n, b) for n, b, _ in _ROWS]
    assert [(r["name"], r["board"]) for r in gold["converged"]] == \
        [(n, b) for n, b, _ in _ROWS]
    assert {n for n, _, _ in _ROWS} == set(FAST_SUBSET)
    assert len(_ROWS) == 10
    assert sum(r["feasible"] + 1 for r in gold["default"]) == \
        gold["default_jobs"] == 80
    assert set(gold["corpus"]) == set(CORPUS_COUNTERS) | {"torch_checked"}


def _default_path(idx):
    want = [_golden()["default"][i] for i in idx]
    ref, ref_meta = default_search("repro", _rows("repro", idx),
                                   **sim_kwargs("repro", "backend"))
    got, meta = default_search("repro_torch", _rows("repro_torch", idx),
                               **sim_kwargs("repro_torch", "backend"))
    assert ref == want, "the reference no longer gives the golden file"
    assert got == want
    assert meta["counts"] == {"event": 0, "cycle": 0, "numpy": 0,
                              "torch": 1, "fallback": 0}
    assert meta["jobs"] == ref_meta["jobs"] == \
        sum(r["feasible"] + 1 for r in want)
    assert meta["backends"] == ["torch-padded"]
    assert meta["analysis"] == ref_meta["analysis"]
    assert "jit_cache" not in meta and "jit_cache" in ref_meta


def test_default_path_on_the_cheap_rows_equals_the_golden_file():
    _default_path(_CHEAP)


@pytest.mark.slow
def test_default_path_on_all_ten_rows_equals_the_golden_file():
    _default_path(range(len(_ROWS)))


def _converged(ids):
    gold = {(r["name"], r["board"]): r for r in _golden()["converged"]}
    rcache, pcache = rcore.FloorplanCache(), pcore.FloorplanCache()
    for name, board, g in _ROWS:
        if f"{name}-{board}" not in ids:
            continue
        pg = next(r[2] for r in fast_rows("repro_torch")
                  if r[:2] == (name, board))
        want = gold[(name, board)]
        ref, _ = converged_search("repro", name, board, g, cache=rcache,
                                  **sim_kwargs("repro"))
        got, res = converged_search("repro_torch", name, board, pg,
                                    cache=pcache, jobs=2,
                                    **sim_kwargs("repro_torch"))
        _check_converged(ref, want)
        _check_converged(got, want)
        pool = res.pool
        assert pool.merged == pool.dispatched > 0
        assert (pool.retried, pool.timed_out, pool.quarantined,
                pool.pool_rebuilds) == (0, 0, 0, 0)
        # one throughput call a round; the baseline simulated once
        assert res.sim_calls == res.rounds_run


def test_converged_path_on_two_rows_with_two_workers():
    _converged(CONVERGED_FAST)


@pytest.mark.slow
def test_converged_path_on_all_ten_rows_with_two_workers():
    _converged(set(_IDS))


def test_corpus_batch_counters_equal_the_golden_file():
    want = _golden()["corpus"]
    rep = pkg_module("repro_torch", "corpus").run_differential(
        corpus_designs("repro_torch"), device="cpu")
    ref = pkg_module("repro", "corpus").run_differential(
        corpus_designs("repro"))
    got = dict(corpus_counters(rep), torch_checked=rep.torch_checked)
    assert got == want
    assert dict(corpus_counters(ref), torch_checked=rep.torch_checked) == \
        want
    assert rep.ok and rep.torch_checked == rep.designs == 26
    assert not hasattr(rep, "jax_checked")


# ---- the device rule, backend names, renamed fields ----------------------

def _tiny(core):
    g = chain_graph(core, n=2)
    grid = core.SlotGrid("g", rows=1, cols=2, base_capacity={"LUT": 150},
                         max_util=1.0)
    return g, grid


_SPACE = dict(space=pcore.SearchSpace(utils=(0.9, 1.0)))


def _entry_points(g, grid):
    """Every search and corpus entry point that reaches
    ``simulate_batch``: name -> (set-up, the call with no device)."""
    corpus = pkg_module("repro_torch", "corpus")
    engine = pkg_module("repro_torch", "search.engine")
    none = lambda: None  # noqa: E731
    prep = lambda: pcore.prepare_design_space(g, grid, **_SPACE)  # noqa
    return {
        "explore_design_space": (none, lambda _: pcore.explore_design_space(
            g, grid, sim_firings=20, **_SPACE)),
        "explore_floorplans": (none, lambda _: pcore.explore_floorplans(
            g, grid, utils=(1.0,), sim_firings=20)),
        "search_until_converged": (
            none, lambda _: pcore.search_until_converged(
                g, grid, rounds=2, points_per_round=2, sim_firings=20)),
        "sweep_backends": (none, lambda _: pcore.sweep_backends(
            g, [grid], sim_firings=20, **_SPACE)),
        "pool_simulations": (prep, lambda p: pcore.pool_simulations(
            [p], firings=20)),
        "timed_pool_simulations": (
            prep, lambda p: pcore.timed_pool_simulations([p], firings=20)),
        "measure_backend_speedup": (
            none, lambda _: pcore.measure_backend_speedup(
                [pcore.SimJob(g)] * 2, firings=20)),
        "_size_fifos": (
            lambda: pcore.explore_design_space(g, grid, sim_firings=20,
                                               device="cpu", **_SPACE),
            lambda res: engine._size_fifos(res, grid, pcore.PhysicalModel(),
                                           20)),
        "run_differential": (none, lambda _: corpus.run_differential(
            corpus.sample_corpus("fuzz", 2), floorplan_limit=0)),
    }


@pytest.mark.parametrize("entry", list(_entry_points(*_tiny(pcore))))
def test_entry_points_default_to_the_card(entry):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    g, grid = _tiny(pcore)
    setup, call = _entry_points(g, grid)[entry]
    arg = setup()
    pcore.reset_floorplan_counts()
    pcore.reset_engine_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(arg)
    # refused before any work: no ILP solve, no simulator run
    assert pcore.floorplan_counts()["solved"] == 0
    assert sum(pcore.engine_counts().values()) == 0


@pytest.mark.parametrize("call", ["explore_design_space", "prepare",
                                  "search_until_converged", "pool"])
def test_the_jax_backend_name_is_refused(call):
    g, grid = _tiny(pcore)
    pcore.reset_floorplan_counts()
    with pytest.raises(ValueError, match="'torch'"):
        if call == "explore_design_space":
            pcore.explore_design_space(g, grid, sim_firings=20,
                                       sim_backend="jax", device="cpu")
        elif call == "prepare":
            pcore.prepare_design_space(g, grid, sim_backend="jax")
        elif call == "search_until_converged":
            pcore.search_until_converged(g, grid, sim_backend="jax",
                                         device="cpu")
        else:
            prep = pcore.prepare_design_space(g, grid, **_SPACE)
            pcore.pool_simulations([prep], firings=20, backend="jax",
                                   device="cpu")
    if call != "pool":
        assert pcore.floorplan_counts()["solved"] == 0


def test_measure_backend_speedup_times_numpy_and_torch():
    g, grid = _tiny(pcore)
    jobs = [pcore.SimJob(g), pcore.SimJob(g, ii={"K1": 2})]
    pcore.reset_engine_counts()
    out = pcore.measure_backend_speedup(jobs, firings=20, device="cpu")
    assert set(out) == {"jobs", "firings", "numpy_wall_s", "torch_first_s",
                        "torch_wall_s", "speedup"}
    assert out["jobs"] == 2 and out["speedup"] > 0
    assert sum(pcore.engine_counts().values()) == 0   # counters restored


def test_timed_pool_simulations_records_the_call_and_no_jit_cache():
    g, grid = _tiny(pcore)
    prep = pcore.prepare_design_space(g, grid, **_SPACE)
    res, meta = pcore.timed_pool_simulations(
        [prep], firings=SEARCH_FIRINGS, backend="torch", device="cpu",
        measure_speedup=True)
    assert set(meta) == {"firings", "jobs", "invocations", "counts",
                         "backends", "backend", "wall_s", "analysis",
                         "speedup"}
    assert meta["jobs"] == len(res) == 3 and meta["invocations"] == 1
    assert meta["backend"] == "torch"
    assert meta["speedup"]["torch_wall_s"] > 0
    assert all(c.sim is not None for c in prep.feasible)


def test_core_exports_the_25_search_names():
    names = pcore._SEARCH_EXPORTS
    assert len(names) == 25 == len(set(names))
    assert set(names) == set(rcore._SEARCH_EXPORTS)
    for name in names:
        assert getattr(pcore, name) is getattr(psearch, name)
        assert name in pcore.__all__ and name in dir(pcore)
    assert not hasattr(pcore, "_PENDING")
    assert psearch.__all__ == pkg_module("repro", "search").__all__
    from repro_torch.core import explorer
    assert explorer is pkg_module("repro_torch", "search.engine")
    with pytest.raises(AttributeError):
        pcore.not_a_search_name  # noqa: B018


def _write_golden():
    rows, _ = default_search("repro", _ROWS, **sim_kwargs("repro", "backend"))
    cache = rcore.FloorplanCache()
    conv = [converged_search("repro", n, b, g, cache=cache, jobs=2,
                             **sim_kwargs("repro"))[0] for n, b, g in _ROWS]
    rep = pkg_module("repro", "corpus").run_differential(
        corpus_designs("repro"))
    assert rep.ok, rep.mismatches
    gold = {"firings": SEARCH_FIRINGS, "utils": list(UTIL_SWEEP),
            "default_jobs": sum(r["feasible"] + 1 for r in rows),
            "default": rows, "converged": conv,
            "corpus": dict(corpus_counters(rep),
                           torch_checked=rep.designs)}
    text = json.dumps(gold, indent=None)
    # one row a line, for readable diffs
    for key in ("default", "converged"):
        text = text.replace(json.dumps(gold[key]), "[\n" + ",\n".join(
            json.dumps(r) for r in gold[key]) + "\n]")
    GOLDEN.write_text(text + "\n")
    print(f"wrote {len(rows)} default and {len(conv)} converged rows and "
          f"the corpus counters to {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_search.py "
                 "--write")
    _write_golden()
