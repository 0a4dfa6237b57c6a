"""The port's converging search (``search_until_converged``) and its
surrogate proposer against the reference's, exactly: rounds, points,
hypervolumes, the reference point, every round's candidates and the merged
frontier (points, objectives, placements, depths), with the uniform and
the surrogate proposer on page_rank and vecadd; ``ResponseSurface`` fits
and ``SurrogateProposer`` proposals bit for bit (both are NumPy host code,
as in the reference).  The reference scores on its NumPy sweep, the port
on the sweep's plain version (``backend="torch", device="cpu"``).
"""
import dataclasses

import numpy as np
import pytest
from _torch_sim import (PKGS, pkg_module, port_obs_isolation,
                        search_design, search_plan_rows, search_rows,
                        sim_kwargs)

assert port_obs_isolation  # the autouse fixture, imported to apply here


def _converge(pkg, name, proposer):
    core = pkg_module(pkg, "core")
    g, grid = search_design(pkg, name)
    space = core.SearchSpace(utils=core.Interval(0.6, 0.95),
                             depth_scales=(1.0, 2.0))
    return core.search_until_converged(
        g, grid, space=space, rounds=3, points_per_round=8,
        sim_firings=100, tol=0.01, proposer=proposer, **sim_kwargs(pkg))


def _converged_rows(res):
    return (res.rounds_run, res.converged, res.points_evaluated,
            res.hypervolumes, res.ref, res.sim_calls, res.proposer,
            search_plan_rows(res.frontier),
            [search_rows(r) for r in res.rounds])


@pytest.mark.parametrize("proposer", ["uniform", "surrogate"])
@pytest.mark.parametrize("name", ["page_rank", "vecadd"])
def test_converged_search_equals_the_reference(name, proposer):
    want = _converged_rows(_converge("repro", name, proposer))
    got = _converge("repro_torch", name, proposer)
    assert _converged_rows(got) == want
    assert got.cache.hits > 0 and len(got.hypervolumes) >= 1


def test_response_surface_fits_and_proposes_as_the_reference():
    rs = pkg_module("repro", "search.surrogate")
    ps = pkg_module("repro_torch", "search.surrogate")
    rng = np.random.default_rng(7)
    raw = rng.uniform(0.5, 1.0, size=(12, 2))
    y = rng.normal(size=(12, 3))
    fits = []
    for mod in (rs, ps):
        pts = [mod.SearchPoint(max_util=float(u), depth_scale=float(d))
               for u, d in raw]
        surf = mod.ResponseSurface()
        assert surf.fit(pts, y)
        fits.append((surf._theta, surf._active, surf.predict(pts)))
    for a, b in zip(*fits):
        assert np.array_equal(a, b)
    # the proposals after a real converged search: vecadd's frontier
    out = []
    for pkg, mod in zip(PKGS, (rs, ps)):
        res = _converge(pkg, "vecadd", "uniform")
        core = pkg_module(pkg, "core")
        work = core.SearchSpace(utils=core.Interval(0.6, 0.95),
                                depth_scales=(1.0, 2.0)).refined(res.frontier)
        every = [c for r in res.rounds for c in r.candidates]
        out.append(mod.SurrogateProposer().propose(
            work, res.frontier, every, 8, seed=3, ref=res.ref))
    assert [dataclasses.astuple(p) for p in out[1]] == \
        [dataclasses.astuple(p) for p in out[0]]
