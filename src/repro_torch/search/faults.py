"""Deterministic fault injection for the crash-safe search stack.

The robustness contract of ``repro_torch.search`` (disk store, checkpointed
``search_until_converged``, hardened worker pool) is *bit-identical results
under failure*: a worker crash, a hung solve, a torn store write or a
SIGKILL between rounds may cost wall time and tick counters, but must never
change the produced frontier.  Proving that needs failures on demand, and
needs them **reproducible** — a chaos run that flakes is worse than no
chaos run.

``FaultPlan`` is that reproducible failure schedule.  Every decision is a
pure function of ``(plan.seed, site, token, attempt)`` — no global RNG, no
wall clock — so the same plan against the same workload injects the same
faults every time, in every process:

    with install(FaultPlan(seed=7, worker_crash=0.5)):
        ...                      # ~half of first-attempt solves die

Sites (each a field on the plan; rate 0 disables the site):

====================  =====================================================
``worker_crash``      pool worker calls ``os._exit`` before solving
``worker_hang``       pool worker sleeps ``hang_s`` (trips the pool timeout)
``torn_write``        the disk store truncates an entry blob mid-write
``parent_kill``       the search process SIGKILLs itself after round
                      ``kill_after_round`` (checkpoint-resume drill)
====================  =====================================================

Crash/hang faults are *transient* by default (``attempts=1``): a selected
token faults on its first ``attempt`` and succeeds on the retry, which is
exactly the failure the pool's retry machinery must absorb.  Set
``attempts`` high to model a *poison* input that kills every worker it
touches — the pool must quarantine it, not retry forever.

Plans propagate to subprocesses via the ``REPRO_FAULTS`` environment
variable (a JSON dict of plan fields), so spawn-context pool workers and
benchmark child processes observe the same schedule as the parent.
``install()`` sets both the in-process plan and the env var.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import signal
import time

from ..obs import metrics as _metrics

#: env var carrying a JSON-encoded plan to subprocesses
ENV_VAR = "REPRO_FAULTS"

#: fault sites whose rate is a plan field
_RATE_SITES = ("worker_crash", "worker_hang", "torn_write")

# Faults injected by THIS process since the last reset.  Worker-side
# injections die with the worker; the pool counts those at dispatch time
# (same seeded decision, taken parent-side) so BENCH JSON can report
# injected-vs-observed without cross-process plumbing.
_FAULT_COUNTS = _metrics.group(
    "faults", {site: 0 for site in _RATE_SITES} | {"parent_kill": 0})


def reset_fault_counts() -> None:
    """Zero this process's injected-fault counters."""
    _FAULT_COUNTS.reset()


def fault_counts() -> dict[str, int]:
    """Snapshot of faults injected (or counted at dispatch) per site."""
    return dict(_FAULT_COUNTS)


def count_injected(site: str) -> None:
    """Record an injection decided on behalf of another process (the pool
    counts worker crash/hang selections at dispatch, because the worker's
    own counter dies with it)."""
    _FAULT_COUNTS[site] += 1


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic failure schedule (see module docstring)."""
    seed: int = 0
    #: per-site selection rates in [0, 1]; 0 disables the site
    worker_crash: float = 0.0
    worker_hang: float = 0.0
    torn_write: float = 0.0
    #: SIGKILL the search process after this checkpoint round (None = never)
    kill_after_round: int | None = None
    #: a selected token faults on attempts ``0..attempts-1`` then succeeds;
    #: large values model a poison input that faults forever
    attempts: int = 1
    #: sleep length of an injected hang (set well above the pool timeout)
    hang_s: float = 30.0

    def decide(self, site: str, token: str, attempt: int = 0) -> bool:
        """Pure seeded decision: does ``site`` fault for ``token`` on this
        ``attempt``?  Same inputs -> same answer, in every process."""
        if site == "parent_kill":
            return (self.kill_after_round is not None
                    and int(token) == int(self.kill_after_round))
        rate = getattr(self, site)
        if rate <= 0.0 or attempt >= self.attempts:
            return False
        return random.Random(f"{self.seed}:{site}:{token}").random() < rate

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


_PLAN: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    """The installed plan, else one parsed from ``REPRO_FAULTS`` (how
    spawn-context workers and benchmark children inherit the schedule)."""
    if _PLAN is not None:
        return _PLAN
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    try:
        return FaultPlan.from_dict(json.loads(raw))
    except (ValueError, TypeError):
        return None


@contextlib.contextmanager
def install(plan: FaultPlan | None, *, env: bool = True):
    """Activate ``plan`` for the enclosed block (and, with ``env=True``,
    for subprocesses started inside it).  ``install(None)`` masks any
    ambient ``REPRO_FAULTS`` so a block provably runs clean."""
    global _PLAN
    prev_plan, prev_env = _PLAN, os.environ.get(ENV_VAR)
    _PLAN = plan
    if env:
        if plan is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = json.dumps(plan.as_dict())
    try:
        yield plan
    finally:
        _PLAN = prev_plan
        if env:
            if prev_env is None:
                os.environ.pop(ENV_VAR, None)
            else:
                os.environ[ENV_VAR] = prev_env


def fire(site: str, token: str, attempt: int = 0) -> bool:
    """Inject ``site`` for ``token`` if the active plan selects it.

    Side effects happen here: ``worker_crash`` hard-exits the process,
    ``worker_hang`` sleeps ``plan.hang_s``, ``parent_kill`` SIGKILLs the
    process.  ``torn_write`` only counts and returns True — the store owns
    the actual corruption (it truncates the blob it was about to write).
    Returns False (a no-op) when no plan is active or the site passes."""
    plan = active_plan()
    if plan is None or not plan.decide(site, token, attempt):
        return False
    _FAULT_COUNTS[site] += 1
    if site == "worker_crash":
        os._exit(23)
    elif site == "worker_hang":
        time.sleep(plan.hang_s)
    elif site == "parent_kill":
        os.kill(os.getpid(), signal.SIGKILL)
    return True
