"""Process-wide metrics registry: counters, gauges, histograms, groups.

The repo grew nine independent ``*_counts()`` surfaces (engine, floorplan,
ilp, analysis, pool, store, faults, sweep-cache) — each a module-global
dict with its own ``reset_*`` helper and, for the cross-process paths, a
bespoke merge function.  This module replaces the storage behind all of
them with one :class:`Registry` while keeping every legacy call site
working unchanged:

* Each legacy dict becomes a :class:`CounterGroup`, a ``MutableMapping``
  registered under a dotted name (``"sim.engine"``, ``"floorplan"``, ...).
  Existing ``_COUNTS["x"] += 1`` increments, ``dict(_COUNTS)`` snapshots,
  and ``clear()``/``update()`` save-restore idioms all still work.
* :meth:`Registry.snapshot` / :meth:`Registry.delta` /
  :meth:`Registry.merge` give one generic cross-process merge path:
  a worker snapshots before work, computes the delta after, ships the
  delta home, and the parent merges it — no per-subsystem merge code.
* :meth:`Registry.restore` puts the whole registry back to a snapshot,
  which is what the per-test isolation fixture uses.

Labelled instruments (:class:`Counter`, :class:`Gauge`,
:class:`Histogram`) cover the new profiling hooks (store hit latency,
jit compile/execute split) that have no legacy dict equivalent.

Merge semantics (property-tested in ``tests/test_obs.py``):

* counters and histogram aggregates **add** — merge is associative and
  commutative, and the zero delta is an identity;
* gauges are **last-writer-wins** and excluded from deltas by default
  (a gauge is a process-local reading, not an accumulating total).

>>> from repro_torch.obs import metrics
>>> reg = metrics.Registry()
>>> g = reg.group("demo", {"hits": 0, "misses": 0})
>>> g["hits"] += 2
>>> before = reg.snapshot()
>>> g["misses"] += 1
>>> reg.delta(before)["demo"]["values"]
{'misses': 1}
"""

from __future__ import annotations

import math
import threading
from collections.abc import Iterator, MutableMapping
from typing import Any, Callable

Number = float | int
Snapshot = dict[str, dict[str, Any]]

_SEP = ","


def _label_key(labels: dict[str, Any]) -> str:
    """Canonical string key for a label set (sorted, ``k=v`` pairs)."""
    if not labels:
        return ""
    return _SEP.join(f"{k}={labels[k]}" for k in sorted(labels))


def parse_label_key(key: str) -> dict[str, str]:
    """Inverse of the label-key encoding (values come back as strings).

    >>> parse_label_key("backend=torch,tier=disk")
    {'backend': 'torch', 'tier': 'disk'}
    >>> parse_label_key("")
    {}
    """
    if not key:
        return {}
    return dict(pair.split("=", 1) for pair in key.split(_SEP))


class CounterGroup(MutableMapping):
    """A named dict of integer counters that lives inside a registry.

    Drop-in replacement for the legacy module-global counter dicts:
    supports item assignment/augmented increments, ``clear()`` (which
    zeroes rather than empties, matching the legacy ``reset_*`` helpers
    that preserve the key set), ``update()``, and ``dict(group)``.
    """

    def __init__(self, name: str, fields: dict[str, Number],
                 on_reset: Callable[[], None] | None = None) -> None:
        self.name = name
        self._defaults = dict(fields)
        self._data: dict[str, Number] = dict(fields)
        self._on_reset = on_reset

    # -- MutableMapping protocol ------------------------------------
    def __getitem__(self, key: str) -> Number:
        return self._data[key]

    def __setitem__(self, key: str, value: Number) -> None:
        self._data[key] = value

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CounterGroup({self.name!r}, {self._data!r})"

    # -- registry hooks ---------------------------------------------
    def clear(self) -> None:
        """Zero every counter (legacy ``reset_*`` semantics).

        Unlike ``dict.clear`` this keeps the key set: the legacy reset
        helpers zeroed values in place, and save/restore call sites do
        ``clear()`` + ``update(saved)``.
        """
        for k in self._data:
            self._data[k] = 0
        if self._on_reset is not None:
            self._on_reset()

    def reset(self) -> None:
        """Restore the group to its registered default values."""
        self._data = dict(self._defaults)
        if self._on_reset is not None:
            self._on_reset()

    def snapshot(self) -> dict[str, Number]:
        return dict(self._data)

    def restore(self, values: dict[str, Number]) -> None:
        self._data = dict(values)
        if self._on_reset is not None:
            self._on_reset()

    def merge(self, values: dict[str, Number]) -> None:
        for k, v in values.items():
            self._data[k] = self._data.get(k, 0) + v


class Counter:
    """A monotonically increasing counter with optional labels.

    >>> c = Counter("requests")
    >>> c.inc()
    >>> c.inc(2, backend="torch")
    >>> c.value()
    1
    >>> c.value(backend="torch")
    2
    """

    kind = "counter"

    def __init__(self, name: str) -> None:
        self.name = name
        self._series: dict[str, Number] = {}

    def inc(self, amount: Number = 1, **labels: Any) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels: Any) -> Number:
        return self._series.get(_label_key(labels), 0)

    def snapshot(self) -> dict[str, Number]:
        return dict(self._series)

    def restore(self, series: dict[str, Number]) -> None:
        self._series = dict(series)

    def reset(self) -> None:
        self._series = {}

    def merge(self, series: dict[str, Number]) -> None:
        for k, v in series.items():
            self._series[k] = self._series.get(k, 0) + v


class Gauge:
    """A last-writer-wins instantaneous reading (process-local).

    Gauges are excluded from cross-process deltas by default: a reading
    taken inside a worker describes that worker, not the parent.
    """

    kind = "gauge"

    def __init__(self, name: str) -> None:
        self.name = name
        self._series: dict[str, Number] = {}

    def set(self, value: Number, **labels: Any) -> None:
        self._series[_label_key(labels)] = value

    def value(self, **labels: Any) -> Number | None:
        return self._series.get(_label_key(labels))

    def snapshot(self) -> dict[str, Number]:
        return dict(self._series)

    def restore(self, series: dict[str, Number]) -> None:
        self._series = dict(series)

    def reset(self) -> None:
        self._series = {}

    def merge(self, series: dict[str, Number]) -> None:
        self._series.update(series)


def _zero_agg() -> dict[str, Number]:
    return {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf}


class Histogram:
    """Streaming aggregate (count/sum/min/max) per label set.

    Full bucketed histograms are overkill for the BENCH block; the
    aggregates are what the regression gates and the top-N summary
    consume, and they merge exactly (count/sum add, min/max combine).

    >>> h = Histogram("latency_s")
    >>> h.observe(0.2, tier="disk")
    >>> h.observe(0.4, tier="disk")
    >>> agg = h.aggregate(tier="disk")
    >>> agg["count"], round(agg["mean"], 3)
    (2, 0.3)
    """

    kind = "histogram"

    def __init__(self, name: str) -> None:
        self.name = name
        self._series: dict[str, dict[str, Number]] = {}

    def observe(self, value: Number, **labels: Any) -> None:
        agg = self._series.setdefault(_label_key(labels), _zero_agg())
        agg["count"] += 1
        agg["sum"] += value
        agg["min"] = min(agg["min"], value)
        agg["max"] = max(agg["max"], value)

    def aggregate(self, **labels: Any) -> dict[str, Number]:
        agg = self._series.get(_label_key(labels))
        if not agg or not agg["count"]:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        return dict(agg) | {"mean": agg["sum"] / agg["count"]}

    def snapshot(self) -> dict[str, dict[str, Number]]:
        return {k: dict(v) for k, v in self._series.items()}

    def restore(self, series: dict[str, dict[str, Number]]) -> None:
        self._series = {k: dict(v) for k, v in series.items()}

    def reset(self) -> None:
        self._series = {}

    def merge(self, series: dict[str, dict[str, Number]]) -> None:
        for k, other in series.items():
            agg = self._series.setdefault(k, _zero_agg())
            agg["count"] += other["count"]
            agg["sum"] += other["sum"]
            agg["min"] = min(agg["min"], other["min"])
            agg["max"] = max(agg["max"], other["max"])


class Registry:
    """Named collection of groups and instruments with generic
    snapshot / delta / merge / restore semantics.

    All mutation is GIL-protected dict arithmetic; a lock guards only
    structural registration so fork-inherited registries stay sane.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[str, Any] = {}

    # -- registration -----------------------------------------------
    def group(self, name: str, fields: dict[str, Number],
              on_reset: Callable[[], None] | None = None) -> CounterGroup:
        """Create (or fetch, if identically shaped) a counter group."""
        with self._lock:
            existing = self._entries.get(name)
            if existing is not None:
                if not isinstance(existing, CounterGroup):
                    raise ValueError(f"{name!r} already registered as "
                                     f"{type(existing).__name__}")
                return existing
            grp = CounterGroup(name, fields, on_reset=on_reset)
            self._entries[name] = grp
            return grp

    def _instrument(self, name: str, cls: type) -> Any:
        with self._lock:
            existing = self._entries.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(f"{name!r} already registered as "
                                     f"{type(existing).__name__}")
                return existing
            inst = cls(name)
            self._entries[name] = inst
            return inst

    def counter(self, name: str) -> Counter:
        return self._instrument(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._instrument(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._instrument(name, Histogram)

    def names(self) -> list[str]:
        return sorted(self._entries)

    def get(self, name: str) -> Any:
        return self._entries.get(name)

    # -- snapshot / delta / merge / restore -------------------------
    @staticmethod
    def _kind(entry: Any) -> str:
        return "group" if isinstance(entry, CounterGroup) else entry.kind

    def snapshot(self) -> Snapshot:
        """Deep copy of every registered metric, tagged by kind."""
        out: Snapshot = {}
        for name, entry in self._entries.items():
            out[name] = {"kind": self._kind(entry),
                         "values": entry.snapshot()}
        return out

    def delta(self, before: Snapshot, *,
              exclude: tuple[str, ...] = ()) -> Snapshot:
        """Change since ``before``, suitable for :meth:`merge`.

        ``exclude`` drops whole entries by name — used by the worker
        pool to keep fault-injection counters out of worker deltas
        (the parent already counts injections at dispatch, so merging
        a surviving worker's own count would double it).

        Gauges are always excluded: a delta is an additive quantity
        and gauges are readings.
        """
        out: Snapshot = {}
        for name, entry in self._entries.items():
            if name in exclude or isinstance(entry, Gauge):
                continue
            prev = before.get(name, {}).get("values", {})
            cur = entry.snapshot()
            if isinstance(entry, Histogram):
                diff = _hist_delta(prev, cur)
            else:
                diff = {k: v - prev.get(k, 0) for k, v in cur.items()
                        if v != prev.get(k, 0)}
            if diff:
                out[name] = {"kind": self._kind(entry), "values": diff}
        return out

    def merge(self, delta: Snapshot) -> None:
        """Fold a delta (usually from another process) into this registry.

        The one generic merge path: replaces the old per-subsystem
        ``merge_floorplan_counts`` / ``merge_solve_counts`` / cache-stat
        plumbing.  Unknown names are registered on the fly so a worker
        with extra instruments still merges cleanly.
        """
        for name, payload in delta.items():
            values = payload.get("values", {})
            entry = self._entries.get(name)
            if entry is None:
                kind = payload.get("kind", "group")
                if kind == "group":
                    entry = self.group(name, {k: 0 for k in values})
                elif kind == "counter":
                    entry = self.counter(name)
                elif kind == "histogram":
                    entry = self.histogram(name)
                else:
                    entry = self.gauge(name)
            entry.merge(values)

    def reset(self, names: tuple[str, ...] | None = None) -> None:
        for name, entry in self._entries.items():
            if names is None or name in names:
                entry.reset()

    def restore(self, snap: Snapshot) -> None:
        """Put every metric back to ``snap`` (per-test isolation).

        Metrics registered after the snapshot was taken are reset to
        their defaults rather than left dirty.
        """
        for name, entry in self._entries.items():
            payload = snap.get(name)
            if payload is None:
                entry.reset()
            else:
                entry.restore(payload["values"])


def _hist_delta(prev: dict[str, dict[str, Number]],
                cur: dict[str, dict[str, Number]]) -> dict:
    out = {}
    for key, agg in cur.items():
        base = prev.get(key)
        count = agg["count"] - (base["count"] if base else 0)
        if count <= 0:
            continue
        out[key] = {"count": count,
                    "sum": agg["sum"] - (base["sum"] if base else 0.0),
                    # min/max of just the new observations are not
                    # recoverable from aggregates; the merged extrema
                    # stay conservative (the union's true extrema).
                    "min": agg["min"], "max": agg["max"]}
    return out


#: The process-wide default registry every subsystem registers into.
REGISTRY = Registry()

group = REGISTRY.group
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
delta = REGISTRY.delta
merge = REGISTRY.merge
reset = REGISTRY.reset
restore = REGISTRY.restore
