"""repro_torch.analysis — static dataflow verifier (pre-flight gate for search).

``analyze(graph)`` classifies a ``TaskGraph`` *without executing a single
firing*: three passes append ``Diagnostic``s (stable code, severity
error/warn/info, subjects, fix hint) to a structured ``Report``.

* **structure** (``A``-codes, ``repro_torch.analysis.structure``): dangling /
  self-loop / zero-width / zero-capacity streams, width changes,
  unreachable or sink-less tasks, pin conflicts against a ``SlotGrid``;
* **deadlock** (``D``-codes, ``repro_torch.analysis.deadlock``): tokenless
  dependency cycles and the per-task static firing bound they imply —
  sound against the event engine (property-tested: a graph ``analyze``
  calls safe never deadlocks in ``simulate`` at the same wave size);
* **rates** (``R``-codes, ``repro_torch.analysis.rates``): SDF balance
  equations / repetition vector plus a static cycles lower bound.

The verifier is wired in as a pre-flight gate across the stack:
``simulate(check="warn"|"raise")``, the search engine's static candidate
gate (``prepare_design_space(static_check=...)``, skipped candidates
counted by ``analysis_counts()``), and
``repro_torch.core.autobridge(check=True)`` caching static-infeasibility
verdicts in its ``repro_torch.core.FloorplanCache``.  See
``docs/analysis-guide.md`` for the full code table and semantics.

>>> from repro_torch.core import TaskGraphBuilder
>>> from repro_torch.analysis import analyze
>>> b = TaskGraphBuilder("pipe")
>>> _ = b.stream("s", width=32, depth=2)
>>> _ = b.invoke("P", outs=["s"])
>>> _ = b.invoke("C", ins=["s"])
>>> rep = analyze(b.build(), firings=10)
>>> rep.ok, rep.deadlock, rep.min_cycles
(True, False, 11)
>>> rep.repetition
{'P': 1, 'C': 1}

A data cycle with empty FIFOs can never fire — ``analyze`` proves the
deadlock statically and bounds every starved task's firings:

>>> b = TaskGraphBuilder("loop")
>>> _ = b.stream("ab"); _ = b.stream("ba")
>>> _ = b.invoke("A", ins=["ba"], outs=["ab"])
>>> _ = b.invoke("B", ins=["ab"], outs=["ba"])
>>> rep = analyze(b.build(), firings=10)
>>> rep.ok, rep.deadlock, rep.firing_bound("A")
(False, True, 0)
>>> sorted(rep.codes())
['A007-unreachable-task', 'A008-sinkless-task', 'D001-dead-cycle']

Closing the loop through a latency-tolerant ``control`` stream (the
paper's page-rank pattern) makes it safe:

>>> b = TaskGraphBuilder("loop2")
>>> _ = b.stream("ab"); _ = b.stream("ba", control=True)
>>> _ = b.invoke("A", ins=["ba"], outs=["ab"])
>>> _ = b.invoke("B", ins=["ab"], outs=["ba"])
>>> analyze(b.build(), firings=10).ok
True
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.core.graph import TaskGraph

from .deadlock import firing_bounds, lint_deadlock
from .rates import lint_rates, min_cycles_bound, repetition_vector
from .report import (ERROR, INFO, WARN, Diagnostic, Report,
                     StaticAnalysisError, _ANALYSIS_COUNTS, analysis_counts,
                     reset_analysis_counts)
from .structure import lint_structure

__all__ = [
    "ERROR", "WARN", "INFO", "Diagnostic", "Report", "StaticAnalysisError",
    "analyze", "analysis_counts", "reset_analysis_counts",
    "firing_bounds", "repetition_vector", "min_cycles_bound",
]

_PASSES = ("structure", "deadlock", "rates")


def analyze(graph: TaskGraph, *,
            grid=None,
            latency: Mapping[str, int] | None = None,
            extra_capacity: Mapping[str, int] | None = None,
            ii: Mapping[str, int] | None = None,
            firings: int | None = None,
            passes: tuple[str, ...] = _PASSES) -> Report:
    """Statically verify ``graph`` under the given simulation knobs.

    grid           — enables the pin lints (``A009``-``A011``)
    latency        — per-stream pipeline registers (cycles bound only;
                     latency can never cause a deadlock)
    extra_capacity — per-stream FIFO headroom beyond the declared depth
                     (e.g. ``Plan.sim_extra_capacity``) — enters the
                     capacity/deadlock analysis exactly as in ``simulate``
    ii             — per-task initiation intervals (cycles bound only)
    firings        — the wave size to verify; with it the deadlock pass
                     renders a verdict (``Report.deadlock``) and the rate
                     pass a ``min_cycles`` bound
    passes         — subset of ``("structure", "deadlock", "rates")``
    """
    unknown = set(passes) - set(_PASSES)
    if unknown:
        raise ValueError(f"unknown analysis pass(es) {sorted(unknown)}")
    _ANALYSIS_COUNTS["analyzed"] += 1
    report = Report(graph_name=graph.name)
    if "structure" in passes:
        lint_structure(graph, report, grid=grid,
                       extra_capacity=extra_capacity)
    if "deadlock" in passes:
        lint_deadlock(graph, report, extra_capacity=extra_capacity,
                      firings=firings)
        if report.deadlock:
            _ANALYSIS_COUNTS["doomed"] += 1
    if "rates" in passes:
        lint_rates(graph, report, latency=latency, ii=ii, firings=firings)
    return report
