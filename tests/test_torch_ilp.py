"""The port's bipartition ILP engine (``repro_torch.core.ilp``) against the
reference's, in one process: the same assignment, cost and ``exact`` flag
from ``solve_bipartition`` (exact branch-and-bound, pinned vertices, tight
capacity, the heuristic alone), the same ``brute_force_bipartition``, the
same infeasibility verdicts, and the ``ilp`` counter group on the port's
registry."""
import numpy as np
import pytest
from _torch_sim import port_obs_isolation

from repro.core import ilp as rilp
from repro_torch.core import ilp as pilp

assert port_obs_isolation  # the autouse fixture, imported to apply here


def _problem(mod, rng, n, n_edges, n_groups=1, cap_slack=1.5, with_k=False,
             resources=("LUT",)):
    """``tests/test_core_ilp.py``'s random problem, built in ``mod``."""
    areas = [{r: float(rng.integers(1, 20)) for r in resources}
             for _ in range(n)]
    group = [int(rng.integers(0, n_groups)) for _ in range(n)]
    caps = []
    for _side in range(2):
        caps.append([{r: max(1.0, sum(areas[i][r] for i in range(n)
                                      if group[i] == g) / 2 * cap_slack)
                      for r in resources} for g in range(n_groups)])
    edges = []
    for _ in range(n_edges):
        u, v = rng.integers(0, n, size=2)
        if u == v:
            continue
        k = float(rng.integers(-2, 3)) if with_k else 0.0
        edges.append(mod.Edge(u=int(u), v=int(v),
                              w=float(rng.integers(1, 64)), k=k))
    return mod.BipartitionProblem(areas=areas, group=group, cap0=caps[0],
                                  cap1=caps[1], edges=edges)


def _both(seed, **kw):
    return tuple(_problem(mod, np.random.default_rng(seed), **kw)
                 for mod in (rilp, pilp))


def _solve(mod, p, **kw):
    try:
        assign, cost, stats = mod.solve_bipartition(p, **kw)
    except mod.InfeasibleError as err:
        return "infeasible", str(err)
    stats = {k: v for k, v in stats.items() if k != "wall_s"}
    return assign, cost, stats


def _assert_same_solve(rp, pp, **kw):
    want = _solve(rilp, rp, **kw)
    got = _solve(pilp, pp, **kw)
    assert got == want
    return got


@pytest.mark.parametrize("seed", range(16))
def test_exact_solves_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(n=int(rng.integers(3, 13)), n_edges=int(rng.integers(2, 20)),
              n_groups=int(rng.integers(1, 3)), with_k=seed % 2 == 0)
    rp, pp = _both(seed, **kw)
    got = _assert_same_solve(rp, pp)
    if got[0] != "infeasible":
        assert got[2]["exact"]
    assert pilp.brute_force_bipartition(pp) == \
        rilp.brute_force_bipartition(rp)


@pytest.mark.parametrize("seed", range(8))
def test_pinned_solves_equal_the_reference(seed):
    rp, pp = _both(100 + seed, n=9, n_edges=12)
    for p in (rp, pp):
        p.pinned = {0: 1, 3: 0}
    _assert_same_solve(rp, pp)
    assert pilp.brute_force_bipartition(pp) == \
        rilp.brute_force_bipartition(rp)


@pytest.mark.parametrize("seed", range(8))
def test_heuristic_only_solves_equal_the_reference(seed):
    """``exact_threshold=0``: the seeded multi-start FM alone, on large
    problems over several groups and two resources."""
    rp, pp = _both(200 + seed, n=120 + 20 * seed, n_edges=300,
                   n_groups=1 + seed % 4, with_k=True,
                   resources=("LUT", "BRAM"))
    got = _assert_same_solve(rp, pp, exact_threshold=0, seed=seed)
    assert got[2]["exact"] is False


@pytest.mark.parametrize("seed", range(6))
def test_tight_capacity_solves_equal_the_reference(seed):
    """Slack below 1: some problems are infeasible, and the verdict and its
    text must match too."""
    rp, pp = _both(300 + seed, n=10, n_edges=14, n_groups=2, cap_slack=1.05)
    _assert_same_solve(rp, pp)
    assert pilp.check_feasible(pp, [0] * pp.n) == \
        rilp.check_feasible(rp, [0] * rp.n)


def test_tight_chain_and_big_vertices():
    def make(mod):
        return mod.BipartitionProblem(
            areas=[{"LUT": 10.0}] * 4, group=[0] * 4,
            cap0=[{"LUT": 20.0}], cap1=[{"LUT": 20.0}],
            edges=[mod.Edge(0, 1, 5.0), mod.Edge(1, 2, 5.0),
                   mod.Edge(2, 3, 5.0)],
            big=[True, False, True, False], slots0=[1], slots1=[1])
    got = _assert_same_solve(make(rilp), make(pilp))
    assert sum(got[0]) == 2 and got[1] == 5.0


def test_edge_cost_terms_equal_the_reference():
    for k, a, b in ((0.0, 1.0, -1.0), (2.0, 0.5, -1.5), (-1.0, 1.0, 0.0)):
        re, pe = rilp.Edge(0, 1, 3.0, k, a, b), pilp.Edge(0, 1, 3.0, k, a, b)
        assert [pe.cost(u, v) for u in (0, 1) for v in (0, 1)] == \
            [re.cost(u, v) for u in (0, 1) for v in (0, 1)]
        assert (pe.min_cost(), pe.min_cost_given_u(1),
                pe.min_cost_given_v(0)) == \
            (re.min_cost(), re.min_cost_given_u(1), re.min_cost_given_v(0))


def test_solve_counter_on_the_port_registry():
    from repro_torch.obs import metrics

    pilp.reset_solve_counts()
    _, pp = _both(5, n=6, n_edges=6)
    pilp.solve_bipartition(pp)
    pilp.solve_bipartition(pp, exact_threshold=0)
    pilp.merge_solve_counts(3)
    assert pilp.solve_counts() == {"bipartitions": 5}
    assert metrics.REGISTRY.snapshot()["ilp"] == {
        "kind": "group", "values": {"bipartitions": 5}}
    pilp.reset_solve_counts()
    assert pilp.solve_counts() == {"bipartitions": 0}
