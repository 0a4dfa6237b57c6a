"""Diagnostic/report types and the static-skip accounting counters.

A ``Diagnostic`` is one finding of the static verifier: a stable code
(``A...`` structural, ``D...`` deadlock, ``R...`` rate), a severity
(``error`` / ``warn`` / ``info``), the graph objects it is about and a fix
hint.  ``Report`` aggregates the diagnostics of one ``analyze()`` run plus
the deadlock pass's firing bounds and the rate pass's repetition vector /
static cycle lower bound.

The module-global counters mirror ``simulate.engine_counts()`` /
``repro_torch.core.floorplan_counts()``: benchmark drivers snapshot them
into the BENCH JSON ``sim.analysis`` block and the CI regression gate
reads them to prove the pre-flight gate actually ran (``analyzed > 0``)
and that static skipping never changed a frontier (``skipped > 0``
implies frontier unchanged vs baseline).
"""
from __future__ import annotations

import dataclasses

from ..obs import metrics as _metrics

ERROR = "error"
WARN = "warn"
INFO = "info"

_SEVERITIES = (ERROR, WARN, INFO)

# analyze() runs / doomed verdicts / gate-skipped candidates / structural
# static-infeasibility verdicts recorded by
# ``repro_torch.core.autobridge(check=True)`` —
# global like the engine/floorplan counters, reset per benchmark run.
_ANALYSIS_COUNTS = _metrics.group(
    "analysis",
    {"analyzed": 0, "doomed": 0, "skipped": 0, "infeasible": 0})


def reset_analysis_counts() -> None:
    """Zero the global static-analysis counters."""
    _ANALYSIS_COUNTS.reset()


def analysis_counts() -> dict[str, int]:
    """Snapshot of analyzer runs, doomed verdicts, gate-skipped candidates
    and static-infeasibility verdicts since the last reset."""
    return dict(_ANALYSIS_COUNTS)


class StaticAnalysisError(ValueError):
    """Raised by ``simulate(check="raise")`` / ``analyze`` consumers when a
    graph fails static verification; carries the full ``Report``."""

    def __init__(self, message: str, report: "Report"):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static-verifier finding."""
    #: stable machine-readable code, e.g. ``A001-dangling-stream``
    code: str
    #: ``error`` (graph is broken / guaranteed to fail), ``warn`` (almost
    #: certainly a bug, but the flow can proceed), ``info`` (notable)
    severity: str
    #: human-readable one-line statement of the finding
    message: str
    #: the task/stream names the finding is about
    subjects: tuple[str, ...] = ()
    #: how to fix it
    hint: str = ""

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def __str__(self) -> str:
        subj = f" [{', '.join(self.subjects)}]" if self.subjects else ""
        return f"{self.severity.upper()} {self.code}{subj}: {self.message}"


@dataclasses.dataclass
class Report:
    """Structured result of one ``analyze()`` run."""
    graph_name: str
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)
    #: static upper bound on firings per *non-detached* task (None =
    #: unbounded/live); filled by the deadlock pass — detached tasks are
    #: excluded because the engine's termination rule ignores them
    max_firings: dict[str, int | None] = dataclasses.field(
        default_factory=dict)
    #: True when the deadlock pass proved the graph cannot complete the
    #: requested firing wave (only set when ``firings`` was given)
    deadlock: bool = False
    #: SDF repetition vector (task -> relative firing rate), or None when
    #: the rate pass found the balance equations inconsistent
    repetition: dict[str, int] | None = None
    #: static lower bound on completion cycles for the requested firing
    #: wave (None when ``firings`` was not given or the graph is doomed)
    min_cycles: int | None = None

    def add(self, code: str, severity: str, message: str, *,
            subjects: tuple[str, ...] = (), hint: str = "") -> Diagnostic:
        d = Diagnostic(code=code, severity=severity, message=message,
                       subjects=tuple(subjects), hint=hint)
        self.diagnostics.append(d)
        return d

    def by_severity(self, severity: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> list[Diagnostic]:
        return self.by_severity(ERROR)

    @property
    def warnings(self) -> list[Diagnostic]:
        return self.by_severity(WARN)

    @property
    def ok(self) -> bool:
        """No error-severity diagnostics (warnings/infos allowed)."""
        return not self.errors

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def firing_bound(self, task: str) -> int | None:
        """Static upper bound on ``task``'s firings (None = unbounded)."""
        return self.max_firings.get(task)

    def doomed(self, firings: int) -> bool:
        """True when some non-detached task provably cannot reach
        ``firings`` firings — the simulator is guaranteed to deadlock."""
        if firings <= 0:
            return False
        return any(b is not None and b < firings
                   for b in self.max_firings.values())

    def summary(self) -> str:
        """One line: ``ok``/``FAIL`` plus the diagnostic tally."""
        n = {s: len(self.by_severity(s)) for s in _SEVERITIES}
        verdict = "ok" if self.ok else "FAIL"
        return (f"{self.graph_name}: {verdict} "
                f"({n[ERROR]} error, {n[WARN]} warn, {n[INFO]} info)")

    def error_summary(self) -> str:
        """Deterministic one-line reason string for error diagnostics —
        the text ``repro_torch.core.autobridge(check=True)`` raises and
        caches, so parallel and sequential search paths produce identical
        verdicts."""
        return "; ".join(f"{d.code}: {d.message}" for d in self.errors)

    def as_dict(self) -> dict:
        """JSON-ready form (the ``python -m repro_torch.analysis --json`` shape)."""
        return {
            "graph": self.graph_name,
            "ok": self.ok,
            "deadlock": self.deadlock,
            "min_cycles": self.min_cycles,
            "repetition": self.repetition,
            "max_firings": dict(self.max_firings),
            "diagnostics": [dataclasses.asdict(d) for d in self.diagnostics],
        }
