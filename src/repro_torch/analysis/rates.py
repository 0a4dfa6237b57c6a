"""SDF-style rate-consistency pass: balance equations, repetition vector,
and a static cycles lower bound.

The core IR is *homogeneous* SDF — every firing moves exactly one token
per port — so the balance equations ``rep(src) * rate_out = rep(dst) *
rate_in`` are trivially consistent with an all-ones repetition vector.
Designs may still annotate multi-rate intent on a stream's ``meta``
(``rate_src`` / ``rate_dst`` tokens per firing, defaulting to the stream's
width on both ends, i.e. rate ratio 1): the pass solves the balance
equations over ``fractions.Fraction`` per weakly-connected component and
flags inconsistencies (``R001``) — a graph whose declared rates cannot be
balanced loses tokens somewhere and will starve or flood at steady state
once the multi-rate semantics are implemented.

The cycles bound is simulator-true and ignores the annotations: with unit
rates, task ``t``'s first firing cannot happen before the longest data
path into it has filled (1 cycle per hop + the stream's pipeline latency),
and its ``firings``-th firing trails by ``(firings - 1) * II(t)``.  The
completion wave therefore needs at least

    max over non-detached t of  fill(t) + (firings - 1) * II(t)  +  1

cycles — a lower bound every engine run must respect (asserted against the
event engine in the tests).  Cyclic data graphs skip the fill term (the
deadlock pass owns that story).
"""
from __future__ import annotations

from fractions import Fraction
from math import lcm
from typing import Mapping

from repro_torch.core.graph import TaskGraph

from .report import WARN, Report


def _rates(s) -> tuple[float, float]:
    """(producer, consumer) tokens-per-firing of one stream; the width is
    the default on both ends, so unannotated streams have ratio 1."""
    return (float(s.meta.get("rate_src", s.width)),
            float(s.meta.get("rate_dst", s.width)))


def repetition_vector(graph: TaskGraph,
                      report: Report | None = None) -> dict[str, int] | None:
    """Smallest positive integer repetition vector of the data graph, or
    ``None`` when the balance equations are inconsistent (``R001``) or a
    rate annotation is non-positive (``R002``)."""
    data = [s for s in graph.streams if not s.control
            and s.src in graph.tasks and s.dst in graph.tasks
            and s.src != s.dst]
    for s in data:
        p, c = _rates(s)
        if p <= 0 or c <= 0:
            if report is not None:
                report.add("R002-nonpositive-rate", WARN,
                           f"stream {s.name!r} declares non-positive rate "
                           f"({p:g} -> {c:g})",
                           subjects=(s.name,),
                           hint="rates (and widths) must be positive")
            return None

    adj: dict[str, list[tuple[str, Fraction]]] = {n: [] for n in graph.tasks}
    for s in data:
        p, c = _rates(s)
        ratio = Fraction(p).limit_denominator(10**9) / \
            Fraction(c).limit_denominator(10**9)
        # rep(dst) = rep(src) * p / c along the stream, and inversely back
        adj[s.src].append((s.dst, ratio))
        adj[s.dst].append((s.src, 1 / ratio))

    rep: dict[str, Fraction] = {}
    for root in graph.tasks:
        if root in rep:
            continue
        rep[root] = Fraction(1)
        work = [root]
        while work:
            n = work.pop()
            for m, ratio in adj[n]:
                want = rep[n] * ratio
                if m not in rep:
                    rep[m] = want
                    work.append(m)
                elif rep[m] != want:
                    if report is not None:
                        report.add(
                            "R001-rate-inconsistent", WARN,
                            f"balance equations conflict at task {m!r}: "
                            f"{rep[m]} vs {want} relative firings",
                            subjects=(m,),
                            hint="make the per-path rate products agree "
                            "(classic SDF consistency)")
                    return None
    scale = lcm(*(f.denominator for f in rep.values())) if rep else 1
    ints = {n: int(f * scale) for n, f in rep.items()}
    # normalize each weakly-connected component is overkill here: one
    # global scale keeps the vector integral, which is all consumers need
    return ints


def min_cycles_bound(graph: TaskGraph, *, firings: int,
                     latency: Mapping[str, int] | None = None,
                     ii: Mapping[str, int] | None = None) -> int | None:
    """Static lower bound on completion cycles of a ``firings`` wave, or
    ``None`` when the data graph is cyclic (deadlock territory) or no
    non-detached task exists."""
    latency = latency or {}
    ii = ii or {}
    data = [s for s in graph.streams if not s.control
            and s.src in graph.tasks and s.dst in graph.tasks
            and s.src != s.dst]
    indeg = {n: 0 for n in graph.tasks}
    out: dict[str, list] = {n: [] for n in graph.tasks}
    for s in data:
        indeg[s.dst] += 1
        out[s.src].append(s)
    # Kahn topological fill: fill(t) = earliest first-firing cycle of t
    fill = {n: 0 for n in graph.tasks}
    ready = [n for n in graph.tasks if indeg[n] == 0]
    done = 0
    while ready:
        n = ready.pop()
        done += 1
        for s in out[n]:
            # a token pushed at cycle u is visible at u + 1 + latency
            fill[s.dst] = max(fill[s.dst], fill[n] + 1 + int(latency.get(s.name, 0)))
            indeg[s.dst] -= 1
            if indeg[s.dst] == 0:
                ready.append(s.dst)
    if done < len(graph.tasks):
        return None                         # data cycle: no finite fill
    waves = [fill[n] + (firings - 1) * max(int(ii.get(n, 1)), 1)
             for n, t in graph.tasks.items() if not t.detached]
    if not waves or firings <= 0:
        return 0
    return max(waves) + 1


def lint_rates(graph: TaskGraph, report: Report, *,
               latency: Mapping[str, int] | None = None,
               ii: Mapping[str, int] | None = None,
               firings: int | None = None) -> None:
    """Append the rate (``R``-code) diagnostics to ``report`` and fill
    ``report.repetition`` / ``report.min_cycles``."""
    report.repetition = repetition_vector(graph, report)
    if firings is not None and not report.deadlock:
        report.min_cycles = min_cycles_bound(graph, firings=firings,
                                             latency=latency, ii=ii)
