"""The port's SDC latency balancer (``repro_torch.core.balance``, on the
pure-Python ``core/_flow.py`` in place of networkx) against the
reference's, in one process: the same balances, potentials, overhead and
objective on random SDCs (equal widths, where optima tie, and fractional
widths), parallel streams, zero-latency cycles, the paper's Fig. 9 example
and every design of the suite under pipelined latencies; the same
``CycleError.cycle`` for a positive-latency cycle; and ``_flow``'s
algorithms against networkx's own on random graphs."""
import networkx as nx
import numpy as np
import pytest
from _torch_sim import port_graph, port_obs_isolation

from repro.core import balance as rbal
from repro.fpga import benchmarks as rbench, grid_for as rgrid
from repro_torch.core import _flow, balance as pbal

assert port_obs_isolation  # the autouse fixture, imported to apply here


def _result(res):
    return res.balance, res.potentials, res.overhead, res.objective


def _outcome(mod, edges):
    """``balance_latencies``'s result, or the cycle it reports."""
    try:
        return _result(mod.balance_latencies(list(edges)))
    except mod.CycleError as err:
        return "cycle", err.cycle, str(err)


def _assert_same(edges):
    want = _outcome(rbal, edges)
    got = _outcome(pbal, edges)
    assert got == want
    return got


def _random_sdc(rng, n, m, widths, parallel=0.0, back=0.0, back_lat=0):
    """A random DAG on ``n`` nodes with ``m`` streams (latency 0-3, widths
    drawn from ``widths``), a share of them doubled between the same pair,
    and ``back`` of them closing a cycle of latency ``back_lat``."""
    edges = []
    for j in range(m):
        u, v = sorted(rng.integers(0, n, size=2).tolist())
        if u == v:
            continue
        w = float(rng.choice(widths))
        edges.append((f"e{j}", f"v{u}", f"v{v}", int(rng.integers(0, 4)), w))
        if rng.random() < parallel:
            edges.append((f"p{j}", f"v{u}", f"v{v}", int(rng.integers(0, 4)),
                          float(rng.choice(widths))))
        if rng.random() < back:
            edges.append((f"b{j}", f"v{v}", f"v{u}", back_lat, w))
    return edges


@pytest.mark.parametrize("seed", range(40))
def test_random_sdcs_equal_widths(seed):
    """Unit widths: many optima tie, so the flow's pivots decide which one
    the balancer returns."""
    rng = np.random.default_rng(seed)
    _assert_same(_random_sdc(rng, int(rng.integers(3, 14)),
                             int(rng.integers(2, 40)), [1.0]))


@pytest.mark.parametrize("seed", range(30))
def test_random_sdcs_fractional_widths(seed):
    rng = np.random.default_rng(1000 + seed)
    _assert_same(_random_sdc(rng, int(rng.integers(3, 14)),
                             int(rng.integers(2, 40)),
                             [0.5, 1.0, 1.5, 2.0, 32.0], parallel=0.2))


def _sdc_with_zero_latency_cycles(rng, n, m):
    """Streams that never climb a random level h of their nodes, with a
    latency of at most h(src) - h(dst): every cycle stays on one level and
    carries latency 0, and there are many such cycles."""
    h = rng.integers(0, 4, size=n)
    edges = []
    for j in range(m):
        u, v = (int(x) for x in rng.integers(0, n, size=2))
        if u == v:
            continue
        if h[u] < h[v]:
            u, v = v, u
        edges.append((f"e{j}", f"v{u}", f"v{v}",
                      int(rng.integers(0, h[u] - h[v] + 1)),
                      float(rng.choice([1.0, 0.5]))))
    return edges


@pytest.mark.parametrize("seed", range(20))
def test_random_sdcs_with_zero_latency_cycles(seed):
    rng = np.random.default_rng(2000 + seed)
    got = _assert_same(_sdc_with_zero_latency_cycles(
        rng, int(rng.integers(3, 12)), int(rng.integers(3, 40))))
    assert got[0] != "cycle"


@pytest.mark.parametrize("seed", range(20))
def test_positive_latency_cycles_report_the_same_cycle(seed):
    rng = np.random.default_rng(3000 + seed)
    edges = _random_sdc(rng, int(rng.integers(3, 12)), int(rng.integers(3, 30)),
                        [1.0, 2.0], back=0.3, back_lat=1)
    edges.append(("close", "v1", "v0", 2, 1.0))
    edges.append(("open", "v0", "v1", 0, 1.0))
    got = _assert_same(edges)
    assert got[0] == "cycle" and got[1][0] == got[1][-1]


def test_paper_fig9_example():
    edges = [
        ("e12", "v1", "v2", 0, 1), ("e13", "v1", "v3", 1, 1),
        ("e14", "v1", "v4", 0, 2), ("e15", "v1", "v5", 0, 1),
        ("e16", "v1", "v6", 0, 1),
        ("e27", "v2", "v7", 1, 1), ("e37", "v3", "v7", 1, 1),
        ("e47", "v4", "v7", 0, 1), ("e57", "v5", "v7", 0, 1),
        ("e67", "v6", "v7", 0, 1),
    ]
    balance, _, overhead, _ = _assert_same(edges)
    assert overhead == 7 and balance["e14"] == 0 and balance["e47"] == 2


@pytest.mark.parametrize("edges", [
    [("s1", "a", "b", 2, 1), ("s2", "a", "b", 0, 1)],
    [("s1", "a", "b", 2, 1), ("s2", "a", "b", 0, 1), ("s3", "a", "b", 1, 3),
     ("s4", "b", "c", 1, 1), ("s5", "a", "c", 0, 0.5)],
    [("ab", "a", "b", 0, 1), ("ba", "b", "a", 0, 1), ("bc", "b", "c", 2, 1)],
    [("ab", "a", "b", 1, 0.5), ("ac", "a", "c", 0, 0.5),
     ("ad", "a", "d", 0, 0.5)],
    [("ab", "a", "b", 3, 1.5), ("bd", "b", "d", 0, 0.5),
     ("ad", "a", "d", 0, 4)],
    [("ab", "a", "b", 0, 1), ("cd", "c", "d", 2, 1), ("ce", "c", "e", 0, 1),
     ("ed", "e", "d", 0, 1)],
    [("ab", "a", "b", 0, 1)],
    [],
    [("ab", "a", "b", 1, 1), ("ba", "b", "a", 0, 1)],
    [("ab", "a", "b", 1, 1), ("bc", "b", "c", 1, 1), ("ca", "c", "a", 1, 1),
     ("ad", "a", "d", 3, 1)],
], ids=["parallel", "parallel-mixed", "zero-cycle", "half-fanout",
        "fractional-diamond", "two-components", "single", "empty",
        "two-cycle", "three-cycle"])
def test_hand_built_sdcs(edges):
    _assert_same(edges)


def _pipelined_lat(graph, grid, rng=None):
    """Each stream's pipelining latency under the baseline's packed
    placement, or (``rng`` given) under a random placement."""
    from repro.core import packed_placement
    slots = packed_placement(graph, grid).slots
    if rng is not None:
        cells = grid.slots()
        slots = {n: cells[int(rng.integers(0, len(cells)))]
                 for n in graph.tasks}
    return {s.name: grid.crossing_depth(slots[s.src], slots[s.dst])
            for s in graph.streams}


_ROWS = rbench.autobridge_suite() + rbench.hbm_suite()


@pytest.mark.parametrize("row", range(len(_ROWS)),
                         ids=[f"{n}-{b}" for n, b, _ in _ROWS])
def test_suite_designs_under_pipelined_latencies(row):
    """``balance_graph`` on every design of the suite, under the packed
    placement's latencies and a random placement's (which may close a
    pipelined cycle)."""
    _, board, g = _ROWS[row]
    grid = rgrid(board)
    pg = port_graph(g)
    for rng in (None, np.random.default_rng(row)):
        lat = _pipelined_lat(g, grid, rng)
        outs = []
        for mod, graph in ((rbal, g), (pbal, pg)):
            try:
                outs.append(_result(mod.balance_graph(graph, lat)))
            except mod.CycleError as err:
                outs.append(("cycle", err.cycle))
        assert outs[1] == outs[0]


# ---- _flow against networkx itself --------------------------------------

def _random_digraph(rng, n, m, lo, hi):
    arcs = []
    for _ in range(m):
        u, v = (int(x) for x in rng.integers(0, n, size=2))
        arcs.append((u, v, int(rng.integers(lo, hi + 1))))
    G, H = nx.DiGraph(), _flow.DiGraph()
    for u, v, w in arcs:
        G.add_edge(u, v, weight=w)
        H.add_edge(u, v, weight=w)
    return G, H


@pytest.mark.parametrize("seed", range(25))
def test_flow_network_simplex_equals_networkx(seed):
    """Random transshipment problems with negative costs on a DAG: the same
    flow on every arc and the same cost."""
    rng = np.random.default_rng(4000 + seed)
    n = int(rng.integers(3, 16))
    G, H = nx.DiGraph(), _flow.DiGraph()
    demand = {}
    for v in range(n):
        G.add_node(v)
        H.add_node(v)
    for _ in range(int(rng.integers(n, 4 * n))):
        u, v = sorted(int(x) for x in rng.integers(0, n, size=2))
        if u == v:
            continue
        w = int(rng.integers(-5, 6))
        G.add_edge(u, v, weight=w)
        H.add_edge(u, v, weight=w)
    for u, v in list(G.edges):
        f = int(rng.integers(0, 4))
        demand[u] = demand.get(u, 0) - f
        demand[v] = demand.get(v, 0) + f
    nx.set_node_attributes(G, {v: demand.get(v, 0) for v in G}, "demand")
    want = nx.network_simplex(G)
    got = _flow.network_simplex(H, demand)
    assert got == want


@pytest.mark.parametrize("seed", range(25))
def test_flow_bellman_ford_and_negative_cycle_equal_networkx(seed):
    rng = np.random.default_rng(5000 + seed)
    G, H = _random_digraph(rng, int(rng.integers(3, 14)),
                           int(rng.integers(3, 40)), -3, 6)
    G.add_node("s")
    H.add_node("s")
    for v in list(G):
        if v != "s":
            G.add_edge("s", v, weight=0)
            H.add_edge("s", v, weight=0)
    try:
        want = ("dist", nx.single_source_bellman_ford_path_length(G, "s"))
    except nx.NetworkXUnbounded:
        want = ("cycle", nx.find_negative_cycle(G, "s"))
    try:
        got = ("dist", _flow.bellman_ford_path_length(H, "s"))
    except _flow.Unbounded:
        got = ("cycle", _flow.find_negative_cycle(H, "s"))
    assert got == want
    if want[0] == "dist":
        with pytest.raises(_flow.NoCycle):
            _flow.find_negative_cycle(H, "s")


@pytest.mark.parametrize("seed", range(15))
def test_flow_find_cycle_equals_networkx(seed):
    rng = np.random.default_rng(6000 + seed)
    G, H = _random_digraph(rng, int(rng.integers(2, 12)),
                           int(rng.integers(1, 16)), 0, 0)
    try:
        want = nx.find_cycle(G)
    except nx.NetworkXNoCycle:
        want = None
    try:
        got = _flow.find_cycle(H)
    except _flow.NoCycle:
        got = None
    assert got == want


def test_flow_connected_components():
    comps = _flow.connected_components("abcdef", [("a", "b"), ("c", "b"),
                                                  ("e", "f")])
    assert sorted(map(sorted, comps)) == [["a", "b", "c"], ["d"], ["e", "f"]]
