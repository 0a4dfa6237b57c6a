"""0/1 ILP engine for one partitioning iteration (paper §4.3).

Every floorplan iteration splits *all* current slots in half simultaneously.
Each movable task gets a binary decision variable ``d_v`` (0 = first child
slot, 1 = second).  The objective is the width-weighted slot-crossing count
in the *new* coordinate system; after the coordinate update (Formulas 3-6)
the per-edge contribution is ``w_e * |K_e + d_u - d_v|`` where
``K_e = 2 * (coord_u - coord_v)`` in the dimension being split.  Capacity
constraints are per (current slot, child, resource).

The paper solves this with Gurobi.  Offline, we provide:

  * an **exact branch-and-bound** (default for <= ``exact_threshold`` free
    variables after same-slot merging) with edge-completion lower bounds and
    an FM-seeded incumbent; and
  * a **multi-start Fiduccia-Mattheyses** local search with prefix-rollback
    passes for larger instances (the classic partitioning heuristic the
    paper's related work [4, 33, 58] builds on).

Both honor capacity, pinning and same-slot (co-location) constraints.
``solve_bipartition`` reports whether the returned solution is proven
optimal (``stats["exact"]``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from ..obs import metrics as _metrics

Area = dict[str, float]

# Bipartition-solver invocations since the last reset.  Each floorplan runs
# one solve per split iteration, so this counter is the ground truth for
# "how many ILPs did a sweep actually pay for" — ``floorplan_counts()`` in
# ``autobridge`` folds it into the cache-hit accounting that benchmarks and
# the CI regression gate inspect.
_SOLVE_COUNTS = _metrics.group("ilp", {"bipartitions": 0})


def reset_solve_counts() -> None:
    """Zero the global bipartition-solver invocation counter."""
    _SOLVE_COUNTS.reset()


def solve_counts() -> dict[str, int]:
    """Snapshot of bipartition-solver invocations since the last reset."""
    return dict(_SOLVE_COUNTS)


def merge_solve_counts(bipartitions: int) -> None:
    """Fold a worker process's bipartition-count delta into this process's
    counter.  Module globals are per-process, so solves performed inside a
    ``ProcessPoolExecutor`` worker are invisible here until the pool merges
    the worker's delta back (the design-space search's worker pool)."""
    _SOLVE_COUNTS["bipartitions"] += int(bipartitions)


@dataclasses.dataclass
class Edge:
    """Cost term ``w * |k + a*du + b*dv|``.

    For a uniform power-of-two split this reduces to the paper's
    ``w * |K + du - dv|`` (a=1, b=-1); the general coefficients support
    non-power-of-two grids (e.g. U280's 2x3) where child-slot coordinate
    offsets differ per current slot.
    """
    u: int
    v: int
    w: float
    k: float = 0.0
    a: float = 1.0
    b: float = -1.0

    def cost(self, du: int, dv: int) -> float:
        return self.w * abs(self.k + self.a * du + self.b * dv)

    def min_cost(self) -> float:
        return self.w * min(abs(self.k + self.a * du + self.b * dv)
                            for du in (0, 1) for dv in (0, 1))

    def min_cost_given_u(self, du: int) -> float:
        return self.w * min(abs(self.k + self.a * du + self.b * dv)
                            for dv in (0, 1))

    def min_cost_given_v(self, dv: int) -> float:
        return self.w * min(abs(self.k + self.a * du + self.b * dv)
                            for du in (0, 1))


@dataclasses.dataclass
class BipartitionProblem:
    """One global split of all current slots.

    areas[i]  — resource vector of (merged) vertex i
    group[i]  — current-slot index of vertex i
    cap0/cap1 — per current-slot child capacities (list of Area, len = #groups)
    edges     — Edge list over vertex indices
    pinned    — {vertex: 0/1} hard assignments (location constraints)
    big[i]    — vertex too large to share a leaf slot with another big one
                (> half a leaf slot in some soft resource); a child region of
                k leaf slots admits at most k big vertices.  This is the
                granularity guard that keeps aggregate-capacity splits from
                stranding monolithic kernels (e.g. SODA) in regions that can
                never be leaf-packed.
    slots0/1  — leaf-slot count of each group's children
    """
    areas: list[Area]
    group: list[int]
    cap0: list[Area]
    cap1: list[Area]
    edges: list[Edge]
    pinned: dict[int, int] = dataclasses.field(default_factory=dict)
    big: list[bool] | None = None
    slots0: list[int] | None = None
    slots1: list[int] | None = None

    @property
    def n(self) -> int:
        return len(self.areas)


def _resource_keys(p: BipartitionProblem) -> list[str]:
    keys: set[str] = set()
    for a in p.areas:
        keys.update(a)
    out = []
    for k in sorted(keys):
        if any(k in c for c in p.cap0) or any(k in c for c in p.cap1):
            out.append(k)
    return out


class _Loads:
    """Vectorized per-(group, side, resource) load tracking."""

    def __init__(self, p: BipartitionProblem, keys: list[str]):
        self.keys = keys
        ngroups = max(p.group) + 1 if p.group else 1
        self.area = np.zeros((p.n, len(keys)))
        for i, a in enumerate(p.areas):
            for j, k in enumerate(keys):
                self.area[i, j] = a.get(k, 0.0)
        inf = float("inf")
        self.cap = np.full((ngroups, 2, len(keys)), inf)
        for g in range(ngroups):
            for side, caps in ((0, p.cap0), (1, p.cap1)):
                for j, k in enumerate(keys):
                    if k in caps[g]:
                        self.cap[g, side, j] = caps[g][k]
        self.load = np.zeros((ngroups, 2, len(keys)))
        # granularity guard: at most `slots` big vertices per child region
        self.big = np.array(p.big if p.big is not None else [False] * p.n)
        self.big_cap = np.full((ngroups, 2), np.inf)
        if p.slots0 is not None:
            for g in range(ngroups):
                self.big_cap[g, 0] = p.slots0[g]
                self.big_cap[g, 1] = p.slots1[g]
        self.big_load = np.zeros((ngroups, 2))

    def fits(self, g: int, side: int, i: int) -> bool:
        if self.big[i] and self.big_load[g, side] + 1 > self.big_cap[g, side]:
            return False
        return bool(np.all(self.load[g, side] + self.area[i]
                           <= self.cap[g, side] + 1e-9))

    def add(self, g: int, side: int, i: int) -> None:
        self.load[g, side] += self.area[i]
        if self.big[i]:
            self.big_load[g, side] += 1

    def remove(self, g: int, side: int, i: int) -> None:
        self.load[g, side] -= self.area[i]
        if self.big[i]:
            self.big_load[g, side] -= 1

    def imbalance(self) -> float:
        """Sum over groups/resources of |load1 - load0| (tie-break term)."""
        return float(np.abs(self.load[:, 1] - self.load[:, 0]).sum())


def total_cost(p: BipartitionProblem, assign: Sequence[int]) -> float:
    return sum(e.cost(assign[e.u], assign[e.v]) for e in p.edges)


def check_feasible(p: BipartitionProblem, assign: Sequence[int]) -> bool:
    keys = _resource_keys(p)
    loads = _Loads(p, keys)
    for i, d in enumerate(assign):
        if i in p.pinned and d != p.pinned[i]:
            return False
        if not loads.fits(p.group[i], d, i):
            return False
        loads.add(p.group[i], d, i)
    return True


# --------------------------------------------------------------------------
# Greedy feasible construction + FM refinement
# --------------------------------------------------------------------------

def _greedy_initial(p: BipartitionProblem, loads: _Loads,
                    rng: np.random.Generator) -> list[int] | None:
    order = sorted(range(p.n), key=lambda i: -float(loads.area[i].sum()))
    assign = [-1] * p.n
    for i in order:
        if i in p.pinned:
            side = p.pinned[i]
            if not loads.fits(p.group[i], side, i):
                return None
            assign[i] = side
            loads.add(p.group[i], side, i)
            continue
        g = p.group[i]
        # prefer the side with more head-room (normalized), tie-break random
        room = []
        for side in (0, 1):
            cap = loads.cap[g, side]
            with np.errstate(invalid="ignore"):
                frac = np.where(np.isfinite(cap) & (cap > 0),
                                (cap - loads.load[g, side]) / np.maximum(cap, 1e-9),
                                1.0)
            # a zero-resource problem (every area vector empty) has no
            # head-room axis at all: both sides are equally fine
            room.append(float(frac.min()) if frac.size else 1.0)
        first = int(room[1] > room[0] + 1e-12)
        if room[0] == room[1]:
            first = int(rng.integers(0, 2))
        for side in (first, 1 - first):
            if loads.fits(g, side, i):
                assign[i] = side
                loads.add(g, side, i)
                break
        else:
            return None
    return assign


def _fm_refine(p: BipartitionProblem, assign: list[int], loads: _Loads,
               max_passes: int = 12) -> float:
    """FM passes with prefix rollback and O(deg) incremental gain updates.
    Mutates assign/loads in place."""
    n = p.n
    adj: list[list[Edge]] = [[] for _ in range(n)]
    for e in p.edges:
        adj[e.u].append(e)
        adj[e.v].append(e)

    def edge_contrib(e: Edge, v: int) -> float:
        """Gain contribution of edge e to flipping vertex v."""
        du, dv = assign[e.u], assign[e.v]
        cur = e.cost(du, dv)
        if e.u == v:
            return cur - e.cost(1 - du, dv)
        return cur - e.cost(du, 1 - dv)

    # gains[v] = sum of edge contributions; kept incrementally
    contrib: dict[tuple[int, int], float] = {}
    gains = np.zeros(n)
    for idx, e in enumerate(p.edges):
        for v in (e.u, e.v):
            c = edge_contrib(e, v)
            contrib[(idx, v)] = c
            gains[v] += c
    eidx = {id(e): i for i, e in enumerate(p.edges)}

    def apply_move(i: int) -> None:
        loads.remove(p.group[i], assign[i], i)
        assign[i] = 1 - assign[i]
        loads.add(p.group[i], assign[i], i)
        for e in adj[i]:
            idx = eidx[id(e)]
            for v in (e.u, e.v):
                c = edge_contrib(e, v)
                gains[v] += c - contrib[(idx, v)]
                contrib[(idx, v)] = c

    cost = total_cost(p, assign)
    NEG = -1e30
    for _ in range(max_passes):
        locked = np.zeros(n, dtype=bool)
        for i in p.pinned:
            locked[i] = True
        moves: list[int] = []
        costs: list[float] = [cost]
        cur = cost
        for _step in range(n):
            masked = np.where(locked, NEG, gains)
            best = -1
            # try candidates in descending gain until one fits capacity
            for _tries in range(8):
                i = int(np.argmax(masked))
                if masked[i] <= NEG / 2:
                    break
                if loads.fits(p.group[i], 1 - assign[i], i):
                    best = i
                    break
                masked[i] = NEG
            if best < 0:
                break
            g = float(gains[best])
            apply_move(best)
            locked[best] = True
            cur -= g
            moves.append(best)
            costs.append(cur)
            if cur > costs[0] + 4.0 * (abs(costs[0]) + 1.0):
                break  # diverging; rollback will recover the best prefix
        if not moves:
            break
        k = int(np.argmin(costs))  # keep best prefix, undo the rest
        for i in reversed(moves[k:]):
            apply_move(i)
        new_cost = costs[k]
        if new_cost >= cost - 1e-12:
            break
        cost = new_cost
    return cost


def _balance_eps(p: BipartitionProblem, loads: _Loads) -> float:
    """Tie-break weight: small enough that (eps * any imbalance) can never
    override a genuine crossing-cost difference, large enough to prefer
    balanced children among co-optimal cuts (avoids infeasible dead-ends in
    later split iterations)."""
    wsum = sum(abs(e.w) for e in p.edges) + 1.0
    asum = float(loads.area.sum()) + 1.0
    return 1e-7 * wsum / asum


def _rebalance_pass(p: BipartitionProblem, assign: list[int], loads: _Loads,
                    adj: list[list[Edge]], eps: float) -> None:
    """Greedy zero-cost-gain moves that reduce child imbalance."""
    improved = True
    sweeps = 0
    while improved and sweeps < 6:
        sweeps += 1
        improved = False
        for i in range(p.n):
            if i in p.pinned:
                continue
            g, d = p.group[i], assign[i]
            if not loads.fits(g, 1 - d, i):
                continue
            dcost = 0.0
            for e in adj[i]:
                du, dv = assign[e.u], assign[e.v]
                ndu = 1 - du if e.u == i else du
                ndv = 1 - dv if e.v == i else dv
                dcost += e.cost(ndu, ndv) - e.cost(du, dv)
            if dcost > 1e-12:
                continue
            before = loads.imbalance()
            loads.remove(g, d, i)
            loads.add(g, 1 - d, i)
            after = loads.imbalance()
            if dcost < -1e-12 or after < before - 1e-9:
                assign[i] = 1 - d
                improved = True
            else:
                loads.remove(g, 1 - d, i)
                loads.add(g, d, i)


def _heuristic(p: BipartitionProblem, n_starts: int, seed: int,
               keys: list[str]) -> tuple[list[int] | None, float]:
    """Returns (assignment, penalized cost)."""
    adj: list[list[Edge]] = [[] for _ in range(p.n)]
    for e in p.edges:
        adj[e.u].append(e)
        adj[e.v].append(e)
    best, best_cost = None, float("inf")
    for s in range(n_starts):
        rng = np.random.default_rng(seed + 1000003 * s)
        loads = _Loads(p, keys)
        assign = _greedy_initial(p, loads, rng)
        if assign is None:
            continue
        eps = _balance_eps(p, loads)
        cost = _fm_refine(p, assign, loads)
        _rebalance_pass(p, assign, loads, adj, eps)
        pen = cost + eps * loads.imbalance()
        if pen < best_cost:
            best, best_cost = list(assign), pen
    return best, best_cost


# --------------------------------------------------------------------------
# Exact branch and bound
# --------------------------------------------------------------------------

def _branch_and_bound(p: BipartitionProblem, keys: list[str],
                      incumbent: list[int] | None, inc_cost: float,
                      deadline: float) -> tuple[list[int] | None, float, bool]:
    n = p.n
    # order by incident weight (descending) so heavy edges are decided early
    weight = np.zeros(n)
    adj: list[list[Edge]] = [[] for _ in range(n)]
    for e in p.edges:
        weight[e.u] += e.w
        weight[e.v] += e.w
        adj[e.u].append(e)
        adj[e.v].append(e)
    order = sorted(range(n), key=lambda i: -weight[i])

    # minimum possible cost of all edges not yet fully decided at depth t:
    # precompute suffix of "free" minima
    base_min = sum(e.min_cost() for e in p.edges)

    assign = [-1] * n
    loads = _Loads(p, keys)
    eps = _balance_eps(p, loads)
    best = list(incumbent) if incumbent is not None else None
    best_cost = inc_cost  # penalized
    exact = True

    def lb_delta(i: int, side: int) -> float:
        """Change in lower bound when assigning i := side."""
        d = 0.0
        for e in adj[i]:
            other = e.v if e.u == i else e.u
            if assign[other] >= 0:
                du = side if e.u == i else assign[e.u]
                dv = side if e.v == i else assign[e.v]
                d += e.cost(du, dv)
                # previously counted as half-decided min
                d -= (e.min_cost_given_u(assign[e.u]) if e.u == other
                      else e.min_cost_given_v(assign[e.v]))
            else:
                d += (e.min_cost_given_u(side) if e.u == i
                      else e.min_cost_given_v(side)) - e.min_cost()
        return d

    lb_stack = [base_min]

    def rec(t: int) -> None:
        nonlocal best, best_cost, exact
        if time.monotonic() > deadline:
            exact = False
            return
        if t == n:
            pen = lb_stack[-1] + eps * loads.imbalance()
            if pen < best_cost - 1e-15:
                best, best_cost = list(assign), pen
            return
        i = order[t]
        sides = (p.pinned[i],) if i in p.pinned else (0, 1)
        # explore the locally-cheaper side first
        if len(sides) == 2:
            d0 = lb_delta(i, 0)
            d1 = lb_delta(i, 1)
            cand = [(d0, 0), (d1, 1)]
            cand.sort()
        else:
            cand = [(lb_delta(i, sides[0]), sides[0])]
        for delta, side in cand:
            new_lb = lb_stack[-1] + delta
            if new_lb >= best_cost - 1e-12:
                continue
            if not loads.fits(p.group[i], side, i):
                continue
            assign[i] = side
            loads.add(p.group[i], side, i)
            lb_stack.append(new_lb)
            rec(t + 1)
            lb_stack.pop()
            loads.remove(p.group[i], side, i)
            assign[i] = -1

    rec(0)
    return best, best_cost, exact


# --------------------------------------------------------------------------

def solve_bipartition(p: BipartitionProblem, *, exact_threshold: int = 22,
                      n_starts: int = 8, seed: int = 0,
                      time_limit_s: float = 6.0) -> tuple[list[int], float, dict]:
    """Solve one partitioning iteration.  Returns (assignment, cost, stats)."""
    _SOLVE_COUNTS["bipartitions"] += 1
    t0 = time.monotonic()
    keys = _resource_keys(p)
    inc, inc_cost = _heuristic(p, n_starts, seed, keys)
    stats = {"n": p.n, "edges": len(p.edges), "exact": False,
             "heuristic_cost": inc_cost}
    n_free = p.n - len(p.pinned)
    if n_free <= exact_threshold:
        best, best_cost, exact = _branch_and_bound(
            p, keys, inc, inc_cost, deadline=t0 + time_limit_s)
        if best is not None:
            inc, inc_cost = best, best_cost
        stats["exact"] = exact
    if inc is None:
        raise InfeasibleError(
            "bipartition infeasible: tasks do not fit in child slots "
            "(raise max_util or coarsen the grid)")
    cost = total_cost(p, inc)  # raw (un-penalized) objective
    stats["cost"] = cost
    stats["wall_s"] = time.monotonic() - t0
    return inc, cost, stats


def brute_force_bipartition(p: BipartitionProblem) -> tuple[list[int] | None, float]:
    """Exhaustive reference solver for tests (n <= ~16)."""
    n = p.n
    best, best_cost = None, float("inf")
    for mask in range(1 << n):
        assign = [(mask >> i) & 1 for i in range(n)]
        if any(assign[i] != d for i, d in p.pinned.items()):
            continue
        if not check_feasible(p, assign):
            continue
        c = total_cost(p, assign)
        if c < best_cost:
            best, best_cost = assign, c
    return best, best_cost


class InfeasibleError(RuntimeError):
    pass
