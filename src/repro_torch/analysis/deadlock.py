"""Static deadlock pass: firing bounds over the capacity graph.

The simulator's model (``repro_torch.core.simulate``) is a *unit-rate marked
graph*: every FIFO starts empty, a firing consumes/produces one token per
stream, and capacity ``cap(s) = depth(s) + extra_capacity(s)``.  Latency
and initiation intervals delay firings but can never deadlock them, and
``control`` streams are excluded from the token model entirely — this pass
analyzes exactly the structure the event engine executes.

Two-step analysis, both in near-linear time:

1. **Dead tasks.**  Build the *zero-token graph*: a forward arc
   ``producer -> consumer`` for every data stream (0 initial tokens ahead
   of the consumer) and a backward arc ``consumer -> producer`` for every
   stream with effective capacity <= 0 (0 initial credits ahead of the
   producer).  Any task on a cycle of this graph can never fire: each arc
   of the cycle says "u fires only after v", with no initial token to
   break the wait.  This covers both classic data cycles (all FIFOs empty)
   and zero-capacity FIFOs (producer blocked forever).

2. **Firing bounds.**  Token conservation gives, for every data stream
   ``s``:  ``fired(consumer) <= fired(producer)`` and
   ``fired(producer) <= fired(consumer) + cap(s)``.  Seeding ``0`` at the
   dead tasks and relaxing these inequalities is a shortest-path problem
   (arc weights 0 forward, ``cap`` backward): ``ub[t]`` = the minimum
   token sum over any path from a dead task to ``t``.  Tasks unreachable
   from every dead task have no finite bound — they are live.

A graph is *doomed* at wave size ``firings`` iff some non-detached task
has ``ub < firings``; the bound is exact enough in both directions that
the property tests in ``tests/test_analysis.py`` hold it against the event
engine on randomized graphs: no "safe" graph may deadlock, and every
"doomed" graph must.
"""
from __future__ import annotations

import heapq
from typing import Mapping

from repro_torch.core.graph import TaskGraph

from .report import ERROR, WARN, Report

_INF = float("inf")


def _dead_sccs(nodes: list[str],
               edges: list[tuple[str, str]]) -> list[list[str]]:
    """Strongly connected components with >= 2 nodes (no self-arcs exist in
    the zero-token graph, so singletons are never dead).  Iterative
    Kosaraju — analysis must not recurse out of stack on deep chains."""
    fwd: dict[str, list[str]] = {n: [] for n in nodes}
    rev: dict[str, list[str]] = {n: [] for n in nodes}
    for u, v in edges:
        fwd[u].append(v)
        rev[v].append(u)

    order: list[str] = []
    seen: set[str] = set()
    for root in nodes:
        if root in seen:
            continue
        stack: list[tuple[str, int]] = [(root, 0)]
        seen.add(root)
        while stack:
            n, i = stack.pop()
            if i < len(fwd[n]):
                stack.append((n, i + 1))
                m = fwd[n][i]
                if m not in seen:
                    seen.add(m)
                    stack.append((m, 0))
            else:
                order.append(n)

    comp: dict[str, int] = {}
    sccs: list[list[str]] = []
    for root in reversed(order):
        if root in comp:
            continue
        cid = len(sccs)
        members = [root]
        comp[root] = cid
        work = [root]
        while work:
            n = work.pop()
            for m in rev[n]:
                if m not in comp:
                    comp[m] = cid
                    members.append(m)
                    work.append(m)
        sccs.append(sorted(members))
    return [s for s in sccs if len(s) >= 2]


def firing_bounds(graph: TaskGraph, *,
                  extra_capacity: Mapping[str, int] | None = None
                  ) -> tuple[dict[str, int | None], list[list[str]]]:
    """``(bounds, dead_cycles)``: the static per-task firing upper bound
    (``None`` = unbounded) and the dead zero-token SCCs that seed it."""
    extra_capacity = extra_capacity or {}
    tasks = list(graph.tasks)
    data = [s for s in graph.streams if not s.control
            and s.src in graph.tasks and s.dst in graph.tasks
            and s.src != s.dst]
    cap = {s.name: int(s.depth) + int(extra_capacity.get(s.name, 0))
           for s in data}

    zero_edges = [(s.src, s.dst) for s in data]
    zero_edges += [(s.dst, s.src) for s in data if cap[s.name] <= 0]
    dead_cycles = _dead_sccs(tasks, zero_edges)
    dead = {n for scc in dead_cycles for n in scc}

    # weighted relaxation graph: token slack along each conservation arc
    arcs: dict[str, list[tuple[str, int]]] = {n: [] for n in tasks}
    for s in data:
        arcs[s.src].append((s.dst, 0))
        arcs[s.dst].append((s.src, max(cap[s.name], 0)))

    dist = {n: (0 if n in dead else _INF) for n in tasks}
    heap = [(0, n) for n in sorted(dead)]
    heapq.heapify(heap)
    while heap:
        d, n = heapq.heappop(heap)
        if d > dist[n]:
            continue
        for m, w in arcs[n]:
            nd = d + w
            if nd < dist[m]:
                dist[m] = nd
                heapq.heappush(heap, (nd, m))

    bounds = {n: (None if dist[n] == _INF else int(dist[n]))
              for n in tasks}
    return bounds, dead_cycles


def lint_deadlock(graph: TaskGraph, report: Report, *,
                  extra_capacity: Mapping[str, int] | None = None,
                  firings: int | None = None) -> None:
    """Append the deadlock (``D``-code) diagnostics to ``report`` and fill
    ``report.max_firings`` (non-detached tasks) / ``report.deadlock``."""
    bounds, dead_cycles = firing_bounds(graph,
                                        extra_capacity=extra_capacity)
    detached = {n: t.detached for n, t in graph.tasks.items()}
    report.max_firings = {n: b for n, b in bounds.items() if not detached[n]}

    for scc in dead_cycles:
        report.add("D001-dead-cycle", ERROR,
                   f"tasks {', '.join(scc)} form a tokenless dependency "
                   "cycle (empty FIFOs / zero capacity) and can never fire",
                   subjects=tuple(scc),
                   hint="give the loop initial credit by closing it with a "
                   "control stream, or break the cycle")

    dead = {n for scc in dead_cycles for n in scc}
    for n, b in sorted(report.max_firings.items()):
        if b is None or n in dead:
            continue
        if firings is None:
            report.add("D002-starved-task", WARN,
                       f"task {n!r} can fire at most {b} times (starved by "
                       "a dead upstream/downstream task)",
                       subjects=(n,),
                       hint="any firing wave larger than the bound "
                       "deadlocks")
        elif b < firings:
            report.add("D002-starved-task", ERROR,
                       f"task {n!r} can fire at most {b} < {firings} times "
                       "— the requested wave is a guaranteed deadlock",
                       subjects=(n,),
                       hint="shrink the wave or fix the dead cycle feeding "
                       "the bound")
    if firings is not None:
        report.deadlock = report.doomed(firings)
