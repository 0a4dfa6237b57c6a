"""Latency balancing of reconvergent paths (paper §5.2).

After the floorplan fixes the pipelining latency ``lat_e`` of every
cross-slot stream, we must add ``balance_e`` extra buffering so that *every
pair of reconvergent paths carries equal total latency* — the cut-set
pipelining condition that guarantees the dataflow throughput is unchanged.

Formulation (verbatim from the paper): integer potentials ``S_i`` per vertex
("maximum pipelining latency from v_i to the sink"), constraints

    S_i >= S_j + lat_ij          for every stream  i -> j
    balance_ij = S_i - S_j - lat_ij

minimize  sum_e width_e * balance_e.

This is a system of difference constraints (SDC): the constraint matrix is a
network matrix, the LP optimum is integral, and the LP dual is a
transshipment (min-cost flow) problem.  We solve it **exactly**:

  1. dual min-cost flow via the network simplex (supply
     ``c_i = sum w(out) - sum w(in)`` at each vertex, arc cost ``-lat_e``);
  2. primal potentials recovered by Bellman-Ford over the residual network
     (complementary slackness makes these optimal; we assert strong duality
     numerically).

Counterpart of ``repro.core.balance``, which runs both steps and its cycle
searches on networkx.  The port does not depend on networkx: ``_flow``
transcribes the networkx algorithms it calls, over the same node and arc
order, so the balances, potentials and reported cycles come out the same
where the optimum is not unique.

Infeasibility <=> a dependency cycle with positive inserted latency
(``CycleError``) — the caller (autobridge) reacts by co-locating the cycle's
vertices and re-floorplanning, exactly as in the paper.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

from . import _flow
from .graph import TaskGraph


def _integer_scale(widths: list[float], *, max_denominator: int = 10 ** 6,
                   max_scale: int = 10 ** 9) -> int:
    """Smallest multiplier turning every width into an (approximate)
    integer.  Exact for the common rational widths (0.5, 1.5, ...); falls
    back to a bounded scale for pathological floats."""
    scale = 1
    for w in widths:
        frac = Fraction(w).limit_denominator(max_denominator)
        scale = scale * frac.denominator // math.gcd(scale, frac.denominator)
        if scale > max_scale:
            return max_scale
    return scale


class CycleError(RuntimeError):
    def __init__(self, cycle: list[str]):
        super().__init__(f"pipelined dependency cycle: {' -> '.join(cycle)}")
        self.cycle = cycle


@dataclasses.dataclass
class BalanceResult:
    #: per-stream added balancing latency (same order/keying as input edges)
    balance: dict[str, int]
    #: vertex potentials S (max pipelining latency to sink)
    potentials: dict[str, int]
    #: total area overhead  sum(width * balance)
    overhead: float
    #: LP objective == flow objective (strong duality check value)
    objective: float


def balance_latencies(edges: list[tuple[str, str, str, int, float]],
                      ) -> BalanceResult:
    """Balance a pipelined dataflow graph.

    edges: list of (name, src, dst, lat, width); lat = latency inserted by
    floorplan-aware pipelining, width = stream width (area cost per unit of
    added depth).
    """
    nodes: set[str] = set()
    for _, s, d, _, _ in edges:
        nodes.add(s)
        nodes.add(d)

    # SDC infeasibility <=> a dependency cycle with positive total inserted
    # latency.  Detect it up front (Bellman-Ford negative-cycle search) so
    # the feedback loop always gets a concrete cycle to co-locate, instead
    # of relying on the network simplex's unboundedness heuristic.
    cyc = _positive_lat_cycle(edges)
    if cyc is not None:
        raise CycleError(cyc)

    if all(lat == 0 for _, _, _, lat, _ in edges):
        # nothing pipelined: the zero solution is trivially optimal
        return BalanceResult(balance={name: 0 for name, *_ in edges},
                             potentials={n: 0 for n in nodes},
                             overhead=0.0, objective=0.0)

    # supplies: c_i = sum w(out) - sum w(in); flow constraint out-in = c_i,
    # the simplex's demand is in-out = -c_i.  network_simplex needs *integer*
    # demands that sum to zero exactly, so scale all widths by the LCM of
    # their denominators first — rounding each node independently (as an
    # earlier revision did) can leave fractional widths like 0.5 with a
    # nonzero demand total (NetworkXUnfeasible) or silently move the
    # optimum.  The scale factor multiplies every supply uniformly, so the
    # dual potentials (and hence the balance solution) are unchanged.
    scale = _integer_scale([w for _, _, _, _, w in edges])
    c: dict[str, int] = {n: 0 for n in nodes}
    for _, s, d, _, w in edges:
        wi = int(round(w * scale))
        c[s] += wi
        c[d] -= wi

    # network_simplex flags "unbounded" whenever some arc carries flow
    # >= faux_inf/2 with faux_inf = 3*max(sum|weights|, max|demand|).  Our
    # width-derived demands can dwarf the latency weights, so a legitimate
    # flow on a wide design used to trip a *false* negative-cycle report
    # (CycleError "<unknown>" on cnn/gaussian).  Scale the arc costs by K
    # so sum|weights| >= total supply: with infinite capacities a basic
    # solution routes at most the total supply through any arc, which is
    # then < faux_inf/2.  The duals scale by exactly K (every residual
    # weight is a multiple of K), undone when recovering S.
    supply = sum(v for v in c.values() if v > 0)
    lat_sum = sum(lat for _, _, _, lat, _ in edges)
    K = max(1, -(-supply // lat_sum))          # ceil(supply / lat_sum)

    # Build flow graph with one midpoint node per edge so parallel streams
    # between the same task pair keep independent duals.
    G = _flow.DiGraph()
    demand: dict = {}
    for n in nodes:
        G.add_node(n)
        demand[n] = -c[n]
    for name, s, d, lat, _w in edges:
        m = ("__mid__", name)
        G.add_node(m)
        demand[m] = 0
        G.add_edge(s, m, weight=-int(lat) * K)
        G.add_edge(m, d, weight=0)

    try:
        flow_cost, flow = _flow.network_simplex(G, demand)
    except _flow.Unbounded:
        raise _find_cycle(edges) from None

    # Residual graph: forward arcs always (cost w), backward when f > 0.
    R = _flow.DiGraph()
    for n in G.adj:
        R.add_node(n)
    for u, v, wgt in G.edges():
        R.add_edge(u, v, weight=wgt)
        if flow.get(u, {}).get(v, 0) > 0:
            # backward arc; parallel opposite arcs are fine in a DiGraph as
            # distinct (v,u) entries unless an edge v->u exists (cannot: all
            # arcs go through unique midpoints).
            R.add_edge(v, u, weight=-wgt)
    src = ("__src__",)
    R.add_node(src)
    for n in G.adj:
        R.add_edge(src, n, weight=0)
    try:
        dist = _flow.bellman_ford_path_length(R, src)
    except _flow.Unbounded:      # defensive: residual negative cycle
        raise _find_cycle(edges) from None

    S = {n: int(round(dist[n] / K)) for n in nodes}
    # normalize each weakly-connected component to min 0
    for comp in _flow.connected_components(
            nodes, ((s, d) for _, s, d, _, _ in edges)):
        lo = min(S[n] for n in comp)
        for n in comp:
            S[n] -= lo

    balance: dict[str, int] = {}
    overhead = 0.0
    objective = 0.0
    for name, s, d, lat, w in edges:
        b = S[s] - S[d] - lat
        assert b >= 0, f"SDC violated on {name}: {S[s]} - {S[d]} < {lat}"
        balance[name] = int(b)
        overhead += w * b
        objective += w * b
    # strong duality: flow_cost = sum(-lat * f); primal obj = sum w*b =
    # sum w*(S_s - S_d) - sum w*lat ; both equal -(flow_cost) - sum(w*lat)
    # up to component normalization, which we skip asserting here and cover
    # in tests against brute force.
    return BalanceResult(balance=balance, potentials=S, overhead=overhead,
                         objective=objective)


def _positive_lat_cycle(edges) -> list[str] | None:
    """Find a dependency cycle with positive total inserted latency (the
    SDC-infeasibility witness), or None.  One Bellman-Ford negative-cycle
    search from a super-source reaching every vertex."""
    H = _flow.DiGraph()
    for _name, s, d, lat, _w in edges:
        # keep the max-latency arc per pair for detection purposes
        if d in H.adj.get(s, ()):
            H.adj[s][d] = min(H.adj[s][d], -lat)
        else:
            H.add_edge(s, d, weight=-lat)
    src = ("__cycsrc__",)
    H.add_node(src)
    for n in list(H.adj):
        if n != src:
            H.add_edge(src, n, weight=0)
    try:
        cyc = _flow.find_negative_cycle(H, src)
    except _flow.NoCycle:
        return None
    return [n for n in cyc if n != src]


def _find_cycle(edges) -> CycleError:
    """Locate a positive-latency cycle for the floorplan feedback loop."""
    cyc = _positive_lat_cycle(edges)
    if cyc is not None:
        return CycleError(cyc)
    # fallback: any directed cycle (all-zero-latency cycles are feasible, so
    # reaching here means numeric trouble; report any cycle)
    H = _flow.DiGraph()
    for _name, s, d, _lat, _w in edges:
        H.add_edge(s, d, weight=1)
    try:
        cyc = [u for u, _ in _flow.find_cycle(H)]
        return CycleError(cyc + [cyc[0]])
    except _flow.NoCycle:
        return CycleError(["<unknown>"])


def balance_graph(graph: TaskGraph, lat: dict[str, int]) -> BalanceResult:
    """Convenience wrapper over a TaskGraph + per-stream latency map.

    Control streams (per-phase handshakes) tolerate latency and are excluded
    from the SDC; they report balance 0."""
    edges = [(s.name, s.src, s.dst, int(lat.get(s.name, 0)), float(s.width))
             for s in graph.streams if not s.control]
    res = balance_latencies(edges)
    for s in graph.streams:
        if s.control:
            res.balance[s.name] = 0
    return res
