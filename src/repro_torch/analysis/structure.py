"""Structural lint pass: graph-shape findings that need no firing model.

Codes (stable; the table lives in ``docs/analysis-guide.md``):

==========================  ========  =========================================
code                        severity  finding
==========================  ========  =========================================
``A001-dangling-stream``    error     stream endpoint is not a task of the graph
``A002-self-loop-stream``   error     stream with ``src == dst``
``A003-nonpositive-width``  error     stream with ``width <= 0``
``A004-negative-depth``     error     stream with ``depth < 0``
``A005-zero-capacity``      error     data stream whose effective capacity
                                      (``depth + extra_capacity``) is ``<= 0``
                                      — its producer can never write
``A006-width-change``       info      single-in/single-out task whose input and
                                      output widths differ
``A007-unreachable-task``   warn      non-detached task no data path from a
                                      source reaches (lives in/behind a cycle)
``A008-sinkless-task``      warn      non-detached task with no data path to a
                                      sink — its results are never drained
``A009-pin-outside-grid``   error     ``Task.pinned`` slot outside the grid
``A010-pin-shared-slot``    warn      several tasks pinned to one slot
``A011-pin-overflow``       error     pinned tasks overflow their slot's
                                      capacity even at ``max_util = 1.0``
``A012-stale-index``        error     ``TaskGraph`` adjacency index out of sync
                                      with the stream list
==========================  ========  =========================================

Pin lints (A009-A011) run only when a ``SlotGrid`` is supplied.
"""
from __future__ import annotations

from collections import deque
from typing import Mapping

from repro_torch.core.graph import TaskGraph

from .report import ERROR, INFO, WARN, Report


def _data_streams(graph: TaskGraph):
    return [s for s in graph.streams if not s.control]


def _reachable(adj: Mapping[str, list[str]], roots) -> set[str]:
    seen = set(roots)
    work = deque(seen)
    while work:
        n = work.popleft()
        for m in adj.get(n, ()):
            if m not in seen:
                seen.add(m)
                work.append(m)
    return seen


def lint_structure(graph: TaskGraph, report: Report, *,
                   grid=None,
                   extra_capacity: Mapping[str, int] | None = None) -> None:
    """Append the structural (``A``-code) diagnostics to ``report``."""
    extra_capacity = extra_capacity or {}
    tasks = graph.tasks

    # -- stream-level lints ------------------------------------------------
    for s in graph.streams:
        missing = [e for e in (s.src, s.dst) if e not in tasks]
        if missing:
            report.add("A001-dangling-stream", ERROR,
                       f"stream {s.name!r} references unknown task(s) "
                       f"{', '.join(repr(m) for m in missing)}",
                       subjects=(s.name,),
                       hint="add the task or remove the stream")
            continue
        if s.src == s.dst:
            report.add("A002-self-loop-stream", ERROR,
                       f"stream {s.name!r} loops {s.src!r} onto itself — the "
                       "task model forbids a task streaming to itself",
                       subjects=(s.name, s.src),
                       hint="split the task or drop the stream")
        if s.width <= 0:
            report.add("A003-nonpositive-width", ERROR,
                       f"stream {s.name!r} has width {s.width!r}",
                       subjects=(s.name,),
                       hint="declare a positive channel width")
        if s.depth < 0:
            report.add("A004-negative-depth", ERROR,
                       f"stream {s.name!r} has depth {s.depth!r}",
                       subjects=(s.name,),
                       hint="declare a non-negative FIFO depth")
        if not s.control:
            cap = int(s.depth) + int(extra_capacity.get(s.name, 0))
            if cap <= 0:
                report.add("A005-zero-capacity", ERROR,
                           f"data stream {s.name!r} has effective capacity "
                           f"{cap} — its producer can never write",
                           subjects=(s.name,),
                           hint="give the FIFO depth >= 1 (or pipeline "
                           "headroom)")

    # -- adjacency-index consistency ---------------------------------------
    want_out: dict[str, list[int]] = {}
    want_in: dict[str, list[int]] = {}
    for i, s in enumerate(graph.streams):
        want_out.setdefault(s.src, []).append(i)
        want_in.setdefault(s.dst, []).append(i)
    have_out = {n: sorted(v) for n, v in graph._out.items() if v}
    have_in = {n: sorted(v) for n, v in graph._in.items() if v}
    if (have_out != {n: sorted(v) for n, v in want_out.items()}
            or have_in != {n: sorted(v) for n, v in want_in.items()}):
        report.add("A012-stale-index", ERROR,
                   "task->stream adjacency index disagrees with the stream "
                   "list (a stream was added without add_stream)",
                   hint="always add streams via TaskGraph.add_stream")

    # Remaining lints walk producer/consumer relations; dangling endpoints
    # would KeyError, so restrict to well-formed data streams.
    data = [s for s in _data_streams(graph)
            if s.src in tasks and s.dst in tasks]

    # -- per-task port lints -----------------------------------------------
    din: dict[str, list] = {n: [] for n in tasks}
    dout: dict[str, list] = {n: [] for n in tasks}
    for s in data:
        dout[s.src].append(s)
        din[s.dst].append(s)
    for n in tasks:
        if len(din[n]) == 1 and len(dout[n]) == 1:
            w_in, w_out = din[n][0].width, dout[n][0].width
            if w_in != w_out:
                report.add("A006-width-change", INFO,
                           f"task {n!r} narrows/widens its stream "
                           f"({w_in:g} -> {w_out:g} bits)",
                           subjects=(n, din[n][0].name, dout[n][0].name),
                           hint="intended for (de)serializers; otherwise a "
                           "width typo")

    # -- reachability ------------------------------------------------------
    fwd: dict[str, list[str]] = {n: [] for n in tasks}
    bwd: dict[str, list[str]] = {n: [] for n in tasks}
    for s in data:
        fwd[s.src].append(s.dst)
        bwd[s.dst].append(s.src)
    sources = [n for n in tasks if not din[n]]
    sinks = [n for n in tasks if not dout[n]]
    from_sources = _reachable(fwd, sources)
    to_sinks = _reachable(bwd, sinks)
    unreachable = tuple(sorted(n for n in tasks
                               if n not in from_sources
                               and not tasks[n].detached))
    if unreachable:
        report.add("A007-unreachable-task", WARN,
                   "no data path from any source reaches "
                   f"{', '.join(unreachable)} (cycle-fed only)",
                   subjects=unreachable,
                   hint="feed the task from a source or mark the loop "
                   "closure as a control stream")
    sinkless = tuple(sorted(n for n in tasks
                            if n not in to_sinks and not tasks[n].detached))
    if sinkless:
        report.add("A008-sinkless-task", WARN,
                   f"no data path from {', '.join(sinkless)} reaches a sink",
                   subjects=sinkless,
                   hint="drain the task's output or detach it")

    # -- pin lints (need a grid) -------------------------------------------
    if grid is None:
        return
    by_slot: dict[tuple[int, int], list[str]] = {}
    for n, t in tasks.items():
        if t.pinned is None:
            continue
        r, c = t.pinned
        if not (0 <= r < grid.rows and 0 <= c < grid.cols):
            report.add("A009-pin-outside-grid", ERROR,
                       f"task {n!r} pinned to slot ({r}, {c}) outside the "
                       f"{grid.rows}x{grid.cols} grid {grid.name!r}",
                       subjects=(n,),
                       hint="fix the pin or pick a larger device")
            continue
        by_slot.setdefault((r, c), []).append(n)
    for slot, names in sorted(by_slot.items()):
        if len(names) > 1:
            report.add("A010-pin-shared-slot", WARN,
                       f"tasks {', '.join(sorted(names))} all pinned to "
                       f"slot {slot}",
                       subjects=tuple(sorted(names)),
                       hint="legal (they co-locate), but check it is "
                       "intentional")
        cap = grid.capacity(*slot, max_util=1.0)
        need: dict[str, float] = {}
        for n in names:
            for k, v in tasks[n].area.items():
                need[k] = need.get(k, 0.0) + v
        over = sorted(k for k, v in need.items()
                      if k in cap and v > cap[k])
        if over:
            report.add("A011-pin-overflow", ERROR,
                       f"tasks pinned to slot {slot} need more "
                       f"{', '.join(over)} than the slot has even at "
                       "max_util=1.0 — every floorplan is infeasible",
                       subjects=tuple(sorted(names)),
                       hint="unpin a task or spread the pins")
