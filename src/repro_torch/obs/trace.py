"""Structured tracing: nestable spans with Chrome/Perfetto export.

Spans record wall-clock intervals into a flat in-process buffer (plain
list appends — atomic under the GIL, no locks on the hot path).  Each
span carries a process-unique id and its parent's id, so the buffer is
a forest that can be re-assembled after worker events are shipped home:

* ``span("search.round", round=3)`` nests via a thread-local stack;
* :func:`current_token` exports the innermost open span's id so a
  ``ProcessPoolExecutor`` worker can :func:`attach` it and have its own
  spans parented under the dispatching round;
* the worker returns :func:`drain` output with its result and the
  parent :func:`absorb`\\ s it — same shape as the registry delta merge.

Tracing is **off by default** (``span`` is then a no-op context
manager); drivers call :func:`enable` around instrumented runs.

Timestamps come from one anchor pair captured at import: epoch µs plus
a ``perf_counter_ns`` origin.  All spans in a process share the anchor,
so intervals nest exactly (no wall-clock steps mid-run), and
fork-started workers inherit it, so cross-process timestamps land on a
common axis.

>>> from repro_torch.obs import trace
>>> trace.enable(clear=True)
>>> with trace.span("demo.outer"):
...     with trace.span("demo.inner", n=1):
...         pass
>>> [e["name"] for e in trace.events()]
['demo.outer', 'demo.inner']
>>> evs = trace.events()
>>> evs[1]["parent"] == evs[0]["id"]
True
>>> trace.disable()
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

# Shared timebase: epoch anchor + monotonic offset (see module docstring).
_T0_EPOCH_NS = time.time_ns()
_T0_PERF_NS = time.perf_counter_ns()

_ENABLED = False
_EVENTS: list[dict[str, Any]] = []
_IDS = itertools.count(1)
_END_SEQ = itertools.count(1)
_LOCAL = threading.local()


def _now_ns() -> int:
    return _T0_EPOCH_NS + (time.perf_counter_ns() - _T0_PERF_NS)


def _stack() -> list[str]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


# -- lifecycle -------------------------------------------------------

def enable(clear: bool = False) -> None:
    """Turn span recording on (optionally clearing the buffer first)."""
    global _ENABLED
    if clear:
        _EVENTS.clear()
        _stack().clear()
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def clear() -> None:
    _EVENTS.clear()
    _stack().clear()


def events() -> list[dict[str, Any]]:
    """Copy of the span buffer (list of span record dicts)."""
    return [dict(e) for e in _EVENTS]


def drain() -> list[dict[str, Any]]:
    """Return and clear the buffer — what a worker ships to its parent."""
    out = [dict(e) for e in _EVENTS]
    _EVENTS.clear()
    return out


def absorb(worker_events: list[dict[str, Any]]) -> None:
    """Fold spans shipped from a worker into this process's buffer."""
    _EVENTS.extend(worker_events)


# -- span recording --------------------------------------------------

def begin(name: str, **args: Any) -> dict[str, Any] | None:
    """Open a span; returns the record (close with :func:`end`)."""
    if not _ENABLED:
        return None
    stack = _stack()
    parent = stack[-1] if stack else getattr(_LOCAL, "base", None)
    rec = {
        "id": f"{os.getpid():x}-{next(_IDS)}",
        "parent": parent,
        "name": name,
        "pid": os.getpid(),
        "tid": threading.get_ident() % 0xFFFFFFFF,
        "t_ns": _now_ns(),
        "dur_ns": None,
        "end_seq": None,
        "args": {k: v for k, v in args.items() if v is not None},
    }
    _EVENTS.append(rec)
    stack.append(rec["id"])
    return rec


def end(rec: dict[str, Any] | None) -> None:
    if rec is None:
        return
    rec["dur_ns"] = _now_ns() - rec["t_ns"]
    rec["end_seq"] = next(_END_SEQ)
    stack = _stack()
    if stack and stack[-1] == rec["id"]:
        stack.pop()
    elif rec["id"] in stack:  # closed out of order: unwind to it
        del stack[stack.index(rec["id"]):]


@contextmanager
def span(name: str, **args: Any) -> Iterator[dict[str, Any] | None]:
    """Record a nested span around the ``with`` body.

    Extra keyword arguments become Perfetto ``args`` on the span;
    ``None`` values are dropped.  Yields the (mutable) span record so
    callers can attach result args before the span closes.
    """
    rec = begin(name, **args)
    try:
        yield rec
    finally:
        end(rec)


# -- cross-process propagation ---------------------------------------

def current_token() -> str:
    """Id of the innermost open span ("" when none) — ship to workers."""
    stack = _stack()
    if stack:
        return stack[-1]
    return getattr(_LOCAL, "base", None) or ""


def attach(token: str) -> None:
    """Adopt ``token`` as the parent for this thread's top-level spans.

    Called at worker entry with the dispatching process's
    :func:`current_token`, so worker spans hang under the dispatching
    round once the parent absorbs them.
    """
    _LOCAL.base = token or None


def begin_worker(token: str, *, enable_tracing: bool) -> None:
    """Reset inherited trace state at worker entry (fork-safe)."""
    global _ENABLED
    _EVENTS.clear()
    _stack().clear()
    attach(token)
    _ENABLED = enable_tracing


# -- Chrome/Perfetto export ------------------------------------------

def to_chrome(span_events: list[dict[str, Any]] | None = None,
              *, process_names: dict[int, str] | None = None) -> dict:
    """Render span records as a Chrome ``trace_event`` document.

    Each closed span becomes a matched B/E pair (the explicit form the
    regression gate validates); unclosed spans are skipped, and the
    :func:`bench_block` ``unclosed`` count is how they surface.  A
    metadata ("M") ``process_name`` event labels each pid.
    """
    spans = _EVENTS if span_events is None else span_events
    my_pid = os.getpid()
    names = dict(process_names or {})
    out: list[tuple] = []
    for i, rec in enumerate(spans):
        if rec.get("dur_ns") is None:
            continue
        pid, tid = rec["pid"], rec["tid"]
        names.setdefault(pid, "repro_torch" if pid == my_pid
                         else "repro_torch-worker")
        args = dict(rec.get("args") or {})
        args["span_id"] = rec["id"]
        if rec.get("parent"):
            args["parent_id"] = rec["parent"]
        t0, t1 = rec["t_ns"], rec["t_ns"] + rec["dur_ns"]
        # Sort key: ns timestamp, then E before B on exact ties (a
        # sibling's end precedes the next begin), then begin/end order.
        out.append(((t0, 1, i),
                    {"name": rec["name"], "cat": rec["name"].split(".")[0],
                     "ph": "B", "ts": t0 / 1000.0, "pid": pid, "tid": tid,
                     "args": args}))
        out.append(((t1, 0, rec.get("end_seq") or i),
                    {"name": rec["name"], "ph": "E", "ts": t1 / 1000.0,
                     "pid": pid, "tid": tid}))
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": label}} for pid, label in sorted(names.items())]
    return {"traceEvents": meta + [ev for _, ev in sorted(out,
                                                          key=lambda p: p[0])],
            "displayTimeUnit": "ms"}


def write_chrome(path: str,
                 span_events: list[dict[str, Any]] | None = None) -> dict:
    doc = to_chrome(span_events)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return doc


def validate_chrome(doc: dict) -> list[str]:
    """Schema-check a Chrome trace document; returns error strings.

    Checks the properties the CI gate cares about: a non-empty
    ``traceEvents`` list, pid/tid/ts on every event, per-(pid, tid)
    monotonic non-decreasing timestamps, and strictly matched B/E
    pairs under stack discipline.
    """
    errors: list[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    tracks: dict[tuple, list[dict]] = {}
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in ("B", "E", "M", "X", "i", "C"):
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "pid" not in ev or "tid" not in ev:
            errors.append(f"event {i}: missing pid/tid")
            continue
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"event {i}: missing ts")
            continue
        tracks.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    n_spans = 0
    for (pid, tid), track in tracks.items():
        last_ts = None
        stack: list[dict] = []
        for ev in track:  # file order; exporter pre-sorts
            if last_ts is not None and ev["ts"] < last_ts:
                errors.append(f"pid {pid} tid {tid}: ts not monotonic "
                              f"({ev['ts']} < {last_ts})")
            last_ts = ev["ts"]
            if ev["ph"] == "B":
                stack.append(ev)
            elif ev["ph"] == "E":
                if not stack:
                    errors.append(f"pid {pid} tid {tid}: E without B "
                                  f"({ev.get('name')})")
                    continue
                top = stack.pop()
                n_spans += 1
                if top.get("name") != ev.get("name"):
                    errors.append(
                        f"pid {pid} tid {tid}: mismatched B/E "
                        f"({top.get('name')!r} closed by {ev.get('name')!r})")
        for ev in stack:
            errors.append(f"pid {pid} tid {tid}: unclosed B "
                          f"({ev.get('name')})")
    if not n_spans and not errors:
        errors.append("no complete spans in trace")
    return errors


# -- BENCH block and summaries ---------------------------------------

def bench_block(total_wall_s: float,
                span_events: list[dict[str, Any]] | None = None) -> dict:
    """The ``sim.obs`` BENCH payload the regression gate inspects.

    ``stage_coverage`` is the fraction of ``total_wall_s`` accounted
    for by *stage* spans — the depth-1 children of root spans (or the
    roots themselves in a flat trace).  Worker spans are parented
    under parent-process spans after :func:`absorb`, so they never
    double-count into coverage.
    """
    spans = _EVENTS if span_events is None else span_events
    closed = [e for e in spans if e.get("dur_ns") is not None]
    ids = {e["id"] for e in spans}
    unclosed = len(spans) - len(closed)
    orphans = sum(1 for e in spans
                  if e.get("parent") and e["parent"] not in ids)
    by_name: dict[str, dict[str, float]] = {}
    for e in closed:
        agg = by_name.setdefault(e["name"], {"count": 0, "wall_s": 0.0})
        agg["count"] += 1
        agg["wall_s"] += e["dur_ns"] / 1e9
    roots = [e for e in closed if not e.get("parent")]
    root_ids = {e["id"] for e in roots}
    stages = [e for e in closed if e.get("parent") in root_ids]
    basis = stages or roots
    covered_s = sum(e["dur_ns"] for e in basis) / 1e9
    coverage = (covered_s / total_wall_s) if total_wall_s > 0 else 0.0
    return {
        "enabled": _ENABLED if span_events is None else True,
        "spans": len(closed),
        "unclosed": unclosed,
        "orphans": orphans,
        "pids": len({e["pid"] for e in spans}) if spans else 0,
        "stage_coverage": round(min(coverage, 1.0), 4),
        "covered_wall_s": round(covered_s, 6),
        "wall_s": round(total_wall_s, 6),
        "by_name": {k: {"count": v["count"],
                        "wall_s": round(v["wall_s"], 6)}
                    for k, v in sorted(by_name.items())},
    }


def summarize(doc: dict, top: int = 15) -> str:
    """Plain-text top-N table (by total wall time) for a Chrome trace."""
    totals: dict[str, dict[str, float]] = {}
    stacks: dict[tuple, list] = {}
    for ev in doc.get("traceEvents", ()):
        key = (ev.get("pid"), ev.get("tid"))
        if ev.get("ph") == "B":
            stacks.setdefault(key, []).append(ev)
        elif ev.get("ph") == "E":
            stack = stacks.get(key)
            if not stack:
                continue
            b = stack.pop()
            agg = totals.setdefault(b.get("name", "?"),
                                    {"count": 0, "wall_us": 0.0})
            agg["count"] += 1
            agg["wall_us"] += ev["ts"] - b["ts"]
    if not totals:
        return "no complete spans"
    rows = sorted(totals.items(), key=lambda kv: -kv[1]["wall_us"])[:top]
    width = max(len(name) for name, _ in rows)
    lines = [f"{'span':<{width}}  {'count':>7}  {'total_ms':>10}  "
             f"{'mean_ms':>9}"]
    for name, agg in rows:
        total_ms = agg["wall_us"] / 1000.0
        lines.append(f"{name:<{width}}  {agg['count']:>7.0f}  "
                     f"{total_ms:>10.2f}  "
                     f"{total_ms / agg['count']:>9.3f}")
    return "\n".join(lines)
