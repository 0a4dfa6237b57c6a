"""Coarse-grained floorplanning by iterative global bipartitioning (paper §4).

The device is an R x C grid of slots (``SlotGrid``).  Starting from every
task in one super-slot spanning the whole grid, we repeatedly split all
current slots in half along one dimension, solving a single global ILP per
iteration (paper §4.3: considering all slots together is what makes the
assignment exact — tightly-connected tasks in different slots still pull on
each other).

Generalizations over the paper (all backwards compatible):
  * boundary *weights*: the cost of crossing a boundary is configurable per
    boundary (pod/DCN boundaries cost more than ICI boundaries on TPU; with
    unit weights the objective is exactly Formula (1));
  * non-power-of-two grids (U280 is 2 x 3): splits may be uneven, handled by
    per-vertex coordinate coefficients in the edge cost;
  * co-location (same-slot) constraints, used by the latency balancer's
    dependency-cycle feedback (paper §5.2) — implemented by merging vertices
    before partitioning;
  * HBM-channel binding (paper §6.2): channels are just another resource
    that only boundary-adjacent slots own (``SlotGrid.slot_caps``).
"""
from __future__ import annotations

import dataclasses

from .devicegrid import SlotGrid
from .graph import TaskGraph, area_add
from .ilp import BipartitionProblem, Edge, InfeasibleError, solve_bipartition


@dataclasses.dataclass
class Floorplan:
    grid: SlotGrid
    placement: dict[str, tuple[int, int]]      # task -> (row, col)
    cost: float                                # weighted crossing cost
    iteration_stats: list[dict]
    max_util: float
    #: per-slot resource loads {slot: {res: used}}
    slot_loads: dict[tuple[int, int], dict[str, float]]

    def utilization(self) -> dict[tuple[int, int], dict[str, float]]:
        out = {}
        for slot, load in self.slot_loads.items():
            cap = dict(self.grid.base_capacity)
            cap.update(self.grid.slot_caps.get(slot, {}))
            util: dict[str, float] = {}
            for k, v in load.items():
                if k not in cap:
                    continue
                if cap[k]:
                    util[k] = v / cap[k]
                else:
                    # nonzero load on a zero-capacity resource is overflow,
                    # not 0% utilization — surface it instead of hiding it.
                    util[k] = float("inf") if v > 0 else 0.0
            out[slot] = util
        return out

    def crossings(self, graph: TaskGraph) -> dict[str, int]:
        """Unweighted boundary crossings per stream (for pipelining)."""
        out = {}
        for s in graph.streams:
            a, b = self.placement[s.src], self.placement[s.dst]
            out[s.name] = abs(a[0] - b[0]) + abs(a[1] - b[1])
        return out


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def _wcoord(bounds: list[float], lo: int, hi: int) -> float:
    """Representative weighted coordinate of a slot range [lo, hi):
    midpoint in cumulative-boundary-weight space."""
    return 0.5 * (bounds[lo] + bounds[hi - 1])


def floorplan(graph: TaskGraph, grid: SlotGrid, *,
              max_util: float | None = None,
              same_slot: list[set[str]] = (),
              seed: int = 0,
              exact_threshold: int = 22,
              n_starts: int = 8,
              time_limit_s: float = 6.0,
              retries: int = 3) -> Floorplan:
    """Assign every task to one slot of ``grid``.

    Raises ``InfeasibleError`` if the design cannot fit under ``max_util``
    (the analogue of an unroutable design; the explorer reacts by sweeping
    the knob, paper §6.3).  Top-down splitting can occasionally paint itself
    into a corner (an early co-optimal but skewed cut starves a later
    split); the balanced tie-break makes this rare and ``retries`` reseeds
    the heuristic when it happens.
    """
    last_err: InfeasibleError | None = None
    # alternate split-dimension order across attempts: a row-first plan can
    # strand big tasks in a thin row that no column split can repack (and
    # vice versa)
    orders = ("auto", "col_first", "row_first")
    for attempt in range(max(retries, 1) * len(orders)):
        try:
            return _floorplan_once(
                graph, grid, max_util=max_util, same_slot=same_slot,
                seed=seed + 7919 * (attempt // len(orders)),
                exact_threshold=exact_threshold,
                n_starts=n_starts + 4 * (attempt // len(orders)),
                time_limit_s=time_limit_s,
                dim_order=orders[attempt % len(orders)])
        except InfeasibleError as err:
            last_err = err
    raise last_err


def _floorplan_once(graph: TaskGraph, grid: SlotGrid, *,
                    max_util: float | None, same_slot: list[set[str]],
                    seed: int, exact_threshold: int, n_starts: int,
                    time_limit_s: float, dim_order: str = "auto") -> Floorplan:
    util = grid.max_util if max_util is None else max_util
    names = list(graph.tasks)
    index = {n: i for i, n in enumerate(names)}

    # ---- merge same-slot groups (co-location constraints) ----------------
    uf = _UnionFind(len(names))
    for group in same_slot:
        members = [index[n] for n in group]
        for m in members[1:]:
            uf.union(members[0], m)
    root_of = [uf.find(i) for i in range(len(names))]
    roots = sorted(set(root_of))
    vid = {r: i for i, r in enumerate(roots)}         # merged-vertex ids
    mv_of_task = [vid[root_of[i]] for i in range(len(names))]
    nmv = len(roots)

    areas: list[dict[str, float]] = [{} for _ in range(nmv)]
    pinned_slot: list[tuple[int, int] | None] = [None] * nmv
    for i, n in enumerate(names):
        m = mv_of_task[i]
        areas[m] = area_add(areas[m], graph.tasks[n].area)
        p = graph.tasks[n].pinned
        if p is not None:
            if pinned_slot[m] is not None and pinned_slot[m] != p:
                raise InfeasibleError(
                    f"conflicting pins in co-located group of {n!r}")
            pinned_slot[m] = p

    medges: list[tuple[int, int, float]] = []
    for s in graph.streams:
        u, v = mv_of_task[index[s.src]], mv_of_task[index[s.dst]]
        if u != v:
            medges.append((u, v, float(s.width)))

    # cumulative boundary-weight coordinates (unit weights -> 0,1,2,...)
    rb = [0.0]
    for b in grid.row_boundaries:
        rb.append(rb[-1] + b.weight)
    cb = [0.0]
    for b in grid.col_boundaries:
        cb.append(cb[-1] + b.weight)

    # ---- iterative global splitting ---------------------------------------
    # each merged vertex carries its current slot range (half-open, in final
    # grid coordinates)
    row_rng = [(0, grid.rows)] * nmv
    col_rng = [(0, grid.cols)] * nmv
    stats: list[dict] = []
    it = 0
    while True:
        max_r = max((hi - lo) for lo, hi in row_rng) if nmv else 1
        max_c = max((hi - lo) for lo, hi in col_rng) if nmv else 1
        if max_r <= 1 and max_c <= 1:
            break
        if dim_order == "col_first":
            dim = "col" if max_c > 1 else "row"
        elif dim_order == "row_first":
            dim = "row" if max_r > 1 else "col"
        else:
            dim = "row" if max_r >= max_c else "col"
        bounds = rb if dim == "row" else cb

        # current slots = distinct (row_rng, col_rng) pairs
        slot_key = {}
        group = [0] * nmv
        for i in range(nmv):
            key = (row_rng[i], col_rng[i])
            if key not in slot_key:
                slot_key[key] = len(slot_key)
            group[i] = slot_key[key]
        ngroups = len(slot_key)

        # child ranges per group (split ranges of size>1; size-1 pass through)
        child_rngs: list[tuple[tuple[int, int], tuple[int, int]]] = [None] * ngroups
        cap0: list[dict] = [None] * ngroups
        cap1: list[dict] = [None] * ngroups
        slots0: list[int] = [0] * ngroups
        slots1: list[int] = [0] * ngroups
        for (rr, cc), g in slot_key.items():
            lo, hi = rr if dim == "row" else cc
            if hi - lo > 1:
                mid = (lo + hi + 1) // 2           # upper-half gets the extra
                c0, c1 = (lo, mid), (mid, hi)
            else:
                c0 = c1 = (lo, hi)
            child_rngs[g] = (c0, c1)

            def _cap(split_rng, rr=rr, cc=cc):
                tot: dict[str, float] = {}
                rows = range(*split_rng) if dim == "row" else range(*rr)
                cols = range(*cc) if dim == "row" else range(*split_rng)
                for r in rows:
                    for c in cols:
                        tot = area_add(tot, grid.capacity(r, c, util))
                return tot
            cap0[g] = _cap(c0)
            cap1[g] = _cap(c1)
            n_other = (cc[1] - cc[0]) if dim == "row" else (rr[1] - rr[0])
            slots0[g] = (c0[1] - c0[0]) * n_other
            slots1[g] = (c1[1] - c1[0]) * n_other

        # per-vertex coordinate model: coord(d) = m0 + d * (m1 - m0)
        m0 = [0.0] * nmv
        m1 = [0.0] * nmv
        pin: dict[int, int] = {}
        for i in range(nmv):
            g = group[i]
            c0, c1 = child_rngs[g]
            m0[i] = _wcoord(bounds, *c0)
            m1[i] = _wcoord(bounds, *c1)
            if c0 == c1:
                pin[i] = 0  # slot not splitting in this dim
            elif pinned_slot[i] is not None:
                target = pinned_slot[i][0] if dim == "row" else pinned_slot[i][1]
                if c0[0] <= target < c0[1]:
                    pin[i] = 0
                elif c1[0] <= target < c1[1]:
                    pin[i] = 1
                else:
                    raise InfeasibleError(
                        f"pin {pinned_slot[i]} outside current slot range")

        edges = [Edge(u=u, v=v, w=w,
                      k=m0[u] - m0[v],
                      a=m1[u] - m0[u],
                      b=-(m1[v] - m0[v]))
                 for (u, v, w) in medges]

        # granularity: a vertex is "big" if it exceeds half a leaf slot in
        # some soft resource (two of those can never share a slot)
        min_leaf = {}
        for r in range(grid.rows):
            for c in range(grid.cols):
                for k, v in grid.capacity(r, c, util).items():
                    if k.endswith("_channels"):
                        continue
                    min_leaf[k] = min(min_leaf.get(k, float("inf")), v)
        big = [any(v > 0.5 * min_leaf[k] for k, v in areas[i].items()
                   if k in min_leaf and min_leaf[k] > 0)
               for i in range(nmv)]

        prob = BipartitionProblem(areas=areas, group=group, cap0=cap0,
                                  cap1=cap1, edges=edges, pinned=pin,
                                  big=big, slots0=slots0, slots1=slots1)
        assign, cost, st = solve_bipartition(
            prob, exact_threshold=exact_threshold, n_starts=n_starts,
            seed=seed + it, time_limit_s=time_limit_s)
        st["dim"] = dim
        st["iteration"] = it
        stats.append(st)

        for i in range(nmv):
            c0, c1 = child_rngs[group[i]]
            new = c1 if assign[i] == 1 else c0
            if dim == "row":
                row_rng[i] = new
            else:
                col_rng[i] = new
        it += 1

    placement = {}
    for i, n in enumerate(names):
        m = mv_of_task[i]
        placement[n] = (row_rng[m][0], col_rng[m][0])

    cost = 0.0
    for s in graph.streams:
        cost += s.width * grid.crossing_weight(placement[s.src], placement[s.dst])

    slot_loads: dict[tuple[int, int], dict[str, float]] = {}
    for n, slot in placement.items():
        slot_loads[slot] = area_add(slot_loads.get(slot, {}), graph.tasks[n].area)

    # final capacity check (the iterative caps were aggregate; verify leaf)
    for slot, load in slot_loads.items():
        cap = grid.capacity(*slot, util)
        for k, v in load.items():
            if k in cap and v > cap[k] + 1e-9:
                raise InfeasibleError(
                    f"slot {slot} over capacity on {k}: {v:.1f} > {cap[k]:.1f}")

    return Floorplan(grid=grid, placement=placement, cost=cost,
                     iteration_stats=stats, max_util=util,
                     slot_loads=slot_loads)
