"""The port's joint search engine, converging search, surrogate and
multi-device sweeps (``repro_torch.search``) against the reference's, on
the same graphs, each package scoring throughput its own way (the
reference on its NumPy sweep, the port on the sweep's plain version,
``backend="torch", device="cpu"``).  Every comparison is exact: points,
fmax, buffer bits, cycles, placements, depths, hypervolumes.

* ``explore_design_space``, ``prepare_design_space`` + ``pool_simulations``
  and the FIFO sizing (``_size_fifos``) on vecadd, stencil_x4 and
  bucket_sort, with ``jobs=1`` and ``jobs=2``;
* ``explore_floorplans`` and the candidates' derived properties;
* ``sweep_backends`` over two grids is one ``simulate_batch`` call and
  its ``table()`` is the reference's;
* the ``>>>`` examples of the port's search and corpus modules.
"""
import dataclasses
import doctest
import importlib

import pytest
from _torch_sim import (PKGS, pkg_module, port_obs_isolation,
                        search_design, search_plan_rows, search_rows,
                        sim_kwargs, vecadd)

import repro.core as rcore
import repro_torch.core as pcore

assert port_obs_isolation  # the autouse fixture, imported to apply here

_SPACE = dict(seeds=(0, 1), utils=(0.6, 0.7, 0.8), depth_scales=(1.0, 2.0))


@pytest.mark.parametrize("name", ["vecadd", "stencil_x4", "bucket_sort"])
def test_explore_design_space_equals_the_reference(name):
    out = {}
    for pkg in PKGS:
        core = pkg_module(pkg, "core")
        g, grid = search_design(pkg, name)
        kw = dict(space=core.SearchSpace(**_SPACE), sim_firings=60,
                  **sim_kwargs(pkg))
        seq = core.explore_design_space(g, grid, **kw)
        par = core.explore_design_space(search_design(pkg, name)[0], grid,
                                        jobs=2, **kw)
        assert search_rows(par) == search_rows(seq)
        out[pkg] = search_rows(seq)
    assert out["repro_torch"] == out["repro"]
    assert out["repro"][0], "an empty frontier proves nothing"


@pytest.mark.parametrize("name", ["vecadd", "bucket_sort"])
def test_prepare_and_pool_simulations_equal_the_reference(name):
    out = {}
    for pkg in PKGS:
        core = pkg_module(pkg, "core")
        g, grid = search_design(pkg, name)
        preps = [core.prepare_design_space(
            g, grid, space=core.SearchSpace(utils=(0.6, 0.8)), jobs=jobs)
            for jobs in (1, 2)]
        core.reset_engine_counts()
        results = core.pool_simulations(preps, firings=80,
                                        **sim_kwargs(pkg, "backend"))
        counts = core.engine_counts()
        out[pkg] = ([search_rows(p.finish(sim_calls=1)) for p in preps],
                    [(r.cycles, r.fired, r.deadlocked, r.steps)
                     for r in results],
                    sum(counts.values()))
        assert out[pkg][0][0] == out[pkg][0][1]   # jobs=1 == jobs=2
    assert out["repro_torch"] == out["repro"]
    assert out["repro"][2] == 1                   # one batched call


@pytest.mark.parametrize("name", ["vecadd", "stencil_x4"])
def test_fifo_sizing_equals_the_reference(name):
    out = {}
    for pkg in PKGS:
        core = pkg_module(pkg, "core")
        g, grid = search_design(pkg, name)
        res = core.explore_design_space(
            g, grid, space=core.SearchSpace(utils=(0.7, 0.9)),
            sim_firings=80, fifo_sizing=True, **sim_kwargs(pkg))
        out[pkg] = [(c.sized_capacity, c.fifo_savings_bits,
                     c.sized_sim and c.sized_sim.cycles,
                     c.sized_report and c.sized_report.fmax_mhz,
                     c.uniform_report and c.uniform_report.fmax_mhz,
                     {n: (p.peak, p.mean, p.full_cycles, p.hist)
                      for n, p in (c.profile or {}).items()})
                    for c in res.frontier]
        assert res.sim_calls == 2
    assert out["repro_torch"] == out["repro"]
    assert any(row[0] for row in out["repro"])


def test_sweep_backends_is_one_batched_call_with_the_reference_table(
        monkeypatch):
    tables = {}
    for pkg in PKGS:
        core = pkg_module(pkg, "core")
        fpga = pkg_module(pkg, "fpga")
        engine = pkg_module(pkg, "search.engine")
        calls = []
        real = engine.simulate_batch

        def counting(jobs, _real=real, _calls=calls, **kw):
            jobs = list(jobs)
            _calls.append(len(jobs))
            return _real(jobs, **kw)

        monkeypatch.setattr(engine, "simulate_batch", counting)
        grids = {"u250": fpga.u250_grid(), "u280": fpga.u280_grid()}
        sweep = core.sweep_backends(vecadd(core), grids,
                                    space=core.SearchSpace(utils=(0.7, 0.8)),
                                    sim_firings=80, **sim_kwargs(pkg))
        assert len(calls) == 1 and sweep.sim_calls == 1
        tables[pkg] = (sweep.table(), sweep.best[0], sweep.best[1].fmax,
                       calls)
    assert tables["repro_torch"] == tables["repro"]


def test_explore_floorplans_equals_the_reference():
    out = []
    for pkg in PKGS:
        core = pkg_module(pkg, "core")
        g, grid = search_design(pkg, "bucket_sort")
        cands = core.explore_floorplans(g, grid, utils=(0.6, 0.7, 0.8),
                                        sim_firings=60, **sim_kwargs(pkg))
        out.append([(c.max_util, c.error is None, c.fmax,
                     c.sim and c.sim.cycles, c.throughput_preserved)
                    for c in cands])
    assert out[0] == out[1]


#: the port's modules with ``>>>`` examples (``repro_torch.core.explorer``
#: is the engine, as ``repro.core.explorer`` is in ``test_doctests.py``)
DOCTEST_MODULES = ("repro_torch.search.engine", "repro_torch.search.space",
                   "repro_torch.search.pareto", "repro_torch.core.explorer",
                   "repro_torch.corpus")


@pytest.mark.parametrize("name", DOCTEST_MODULES)
def test_port_search_doctests(name):
    mod = importlib.import_module(name)
    results = doctest.testmod(mod, verbose=False)
    assert results.attempted > 0, f"{name} lost its >>> examples"
    assert results.failed == 0


def test_candidate_properties_equal_the_reference():
    rows = []
    for core in (rcore, pcore):
        pkg = core.__name__.split(".")[0]
        g, grid = search_design(pkg, "stencil_x4")
        res = core.explore_design_space(
            g, grid, space=core.SearchSpace(utils=(0.7, 1.0)),
            sim_firings=60, **sim_kwargs(pkg))
        rows.append([(c.fmax, c.throughput_preserved, c.fifo_savings_bits,
                      c.plan.summary()) for c in res.candidates])
        assert res.best.fmax == max(c.fmax for c in res.frontier)
    assert rows[0] == rows[1]
