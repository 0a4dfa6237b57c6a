"""Crash-consistent persistence for the search stack.

Two pieces live here, sharing one checksummed-blob file format:

``DiskFloorplanStore``
    A ``FloorplanCache`` whose entries survive the process.  Entries are
    **content-addressed**: the cache key (the exact graph/grid/knob
    signature tuple ``FloorplanCache.key`` already produces) is canonical-
    ized (frozensets sorted — their iteration order is not stable across
    processes) and SHA-256 hashed into the file name, so concurrent
    writers in different processes land the same entry at the same path.
    Every write is atomic (temp file + fsync + ``os.replace``) and every
    blob is checksummed, so a reader can never observe a half-written
    entry: a torn or corrupt file is detected, moved to ``quarantine/``
    and treated as a miss — the solve re-runs, the run stays correct.

``SearchJournal``
    The per-round checkpoint of ``search_until_converged``: one pickled
    state blob per completed round plus an append-only human-readable
    ``journal.jsonl``.  Resume loads the newest *valid* state (a blob torn
    by a crash mid-checkpoint is quarantined and the previous round used),
    and a config fingerprint refuses resumption under different search
    arguments — resuming must reproduce the uninterrupted run bit for bit,
    never silently continue a different one.

Store layout (all relative to the store root)::

    entries/<sha256(key)>.fp   one cache entry (solved plan or verdict)
    quarantine/                corrupt blobs, moved aside for post-mortem
    state_r0007.pkl            round-7 checkpoint (SearchJournal)
    journal.jsonl              one JSON line per checkpointed round

Blob format: ``b"RTS1" + sha256(payload) + payload`` where payload is the
pickled ``(key, value)`` pair (or the checkpoint dict).  Truncation,
bit-rot and partial writes all fail the digest check.

Counterpart of ``repro.search.store``, with a magic of its own: the
reference writes ``b"RFS1"``, and its pickles name ``repro.core`` classes,
so unpickling one would import the JAX package into the port's process
and hand back the reference's ``Floorplan`` objects.  A reference blob
therefore reads as foreign: an entry is quarantined and counted like a
torn one, and never unpickled.  A journal's ``config.json`` names the
package that wrote it, and ``SearchJournal`` refuses a directory another
package wrote.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
import time
from pathlib import Path

from repro_torch.core.autobridge import FloorplanCache, _entry_values_equal

from ..obs import metrics as _metrics
from . import faults

#: blob magic: repro_torch floorplan store, format 1 (the reference's is
#: ``b"RFS1"``; its blobs fail the magic check here and are never unpickled)
_MAGIC = b"RTS1"
#: the package a journal's ``config.json`` names
PACKAGE = "repro_torch"
_DIGEST_LEN = hashlib.sha256().digest_size

# Disk-store activity since the last reset (module-global, mirroring
# ``pool_counts``/``floorplan_counts``): benchmarks surface these in the
# BENCH JSON ``sim.store`` block and the chaos gate asserts torn entries
# really were quarantined.
_STORE_COUNTS = _metrics.group(
    "store",
    {"writes": 0, "disk_hits": 0, "disk_misses": 0,
     "quarantined": 0, "evictions": 0, "conflicts": 0})

#: disk lookup latency, labelled by outcome (hit / miss) — feeds the
#: BENCH ``sim.store.lookup_s`` block and the top-N trace summary.
_LOOKUP_HIST = _metrics.histogram("store.lookup_s")


def reset_store_counts() -> None:
    """Zero the global disk-store counters (and the lookup-latency
    histogram that rides along with them)."""
    _STORE_COUNTS.reset()
    _LOOKUP_HIST.reset()


def store_counts() -> dict[str, int]:
    """Snapshot of disk-store writes/hits/quarantines since last reset."""
    return dict(_STORE_COUNTS)


def store_lookup_stats() -> dict:
    """Disk-lookup latency aggregates per outcome (BENCH
    ``sim.store.lookup_s``): count/sum/min/max/mean seconds for disk
    hits and misses since the last reset."""
    return {"hit": _LOOKUP_HIST.aggregate(outcome="hit"),
            "miss": _LOOKUP_HIST.aggregate(outcome="miss")}


def _canonical(obj):
    """Recursively rewrite ``obj`` so equal keys stringify identically in
    every process: frozensets iterate in hash order, and string hashing is
    randomized per process, so they must be sorted before hashing."""
    if isinstance(obj, frozenset):
        return ("frozenset",) + tuple(
            sorted((_canonical(x) for x in obj), key=repr))
    if isinstance(obj, tuple):
        return tuple(_canonical(x) for x in obj)
    return obj


def key_digest(key: tuple) -> str:
    """Stable content address of a ``FloorplanCache`` key."""
    return hashlib.sha256(repr(_canonical(key)).encode()).hexdigest()


def _write_blob(path: Path, payload: bytes, *, fault_token: str | None = None,
                ) -> None:
    """Atomically write a checksummed blob: temp file in the same
    directory, fsync, then ``os.replace`` — a crash at any point leaves
    either the old file or the new one, never a mix.  ``fault_token``
    wires in the ``torn_write`` injection site: a selected write truncates
    the blob so the corruption-detection path can be drilled on demand."""
    blob = _MAGIC + hashlib.sha256(payload).digest() + payload
    if fault_token is not None and faults.fire("torn_write", fault_token):
        blob = blob[:max(len(_MAGIC), len(blob) // 2)]
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with _suppress():
            os.unlink(tmp)
        raise


def _read_blob(path: Path) -> bytes | None:
    """Read and verify a blob; None when torn/corrupt (caller quarantines)."""
    try:
        raw = path.read_bytes()
    except OSError:
        return None
    if len(raw) < len(_MAGIC) + _DIGEST_LEN or not raw.startswith(_MAGIC):
        return None
    digest = raw[len(_MAGIC):len(_MAGIC) + _DIGEST_LEN]
    payload = raw[len(_MAGIC) + _DIGEST_LEN:]
    if hashlib.sha256(payload).digest() != digest:
        return None
    return payload


class _suppress:
    """``contextlib.suppress(Exception)`` without the import noise."""
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return True


class DiskFloorplanStore(FloorplanCache):
    """A ``FloorplanCache`` backed by a content-addressed directory.

    Drop-in for every ``cache=`` parameter in the search stack: lookups
    fall through memory -> disk -> ILP solve, and every new entry (solved
    plan or infeasibility verdict) is persisted atomically on the way in.
    Multiple processes may share one root concurrently — first writer wins
    per entry, and because ``floorplan()`` is deterministic a second
    writer can only produce the identical value (verified: a disagreeing
    duplicate ticks the ``conflicts`` counter instead of being dropped
    silently).

    ``verify_on_open`` scrubs existing entries at construction: torn or
    corrupt blobs (a writer killed mid-write on a non-atomic filesystem,
    bit rot, injected ``torn_write`` faults) are moved to ``quarantine/``
    immediately, so a resumed run's store is known-good before any lookup.
    """

    def __init__(self, root: str | os.PathLike, *,
                 max_entries: int | None = None,
                 verify_on_open: bool = True) -> None:
        super().__init__()
        self.root = Path(root)
        self.entries_dir = self.root / "entries"
        self.quarantine_dir = self.root / "quarantine"
        self.entries_dir.mkdir(parents=True, exist_ok=True)
        self.quarantine_dir.mkdir(parents=True, exist_ok=True)
        self.max_entries = max_entries
        self.disk_hits = 0
        self.disk_misses = 0
        self.quarantined = 0
        # a writer killed between mkstemp and replace leaves a .tmp behind;
        # they are garbage by construction (replace is the commit point)
        for stale in self.entries_dir.glob("*.tmp"):
            with _suppress():
                stale.unlink()
        if verify_on_open:
            self.scrub()

    # -- integrity -------------------------------------------------------

    def scrub(self) -> int:
        """Validate every on-disk entry, quarantining failures; returns the
        number of entries quarantined."""
        bad = 0
        for path in sorted(self.entries_dir.glob("*.fp")):
            if self._load_entry(path) is None:
                bad += 1
        return bad

    def _quarantine(self, path: Path) -> None:
        with _suppress():
            os.replace(path, self.quarantine_dir / (path.name + ".corrupt"))
        self.quarantined += 1
        _STORE_COUNTS["quarantined"] += 1

    def _load_entry(self, path: Path) -> tuple[tuple, tuple] | None:
        """Read + verify one entry file; quarantines and returns None on
        any integrity failure."""
        payload = _read_blob(path)
        if payload is None:
            self._quarantine(path)
            return None
        try:
            key, value = pickle.loads(payload)
        except Exception:
            self._quarantine(path)
            return None
        if path.stem != key_digest(key):
            # blob is internally consistent but filed under the wrong
            # address — treat as corrupt rather than serving a wrong key
            self._quarantine(path)
            return None
        return key, value

    # -- FloorplanCache storage hooks ------------------------------------

    def _entry_path(self, key: tuple) -> Path:
        return self.entries_dir / (key_digest(key) + ".fp")

    def _lookup(self, key: tuple):
        hit = self._entries.get(key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        path = self._entry_path(key)
        if not path.exists():
            self.disk_misses += 1
            _STORE_COUNTS["disk_misses"] += 1
            _LOOKUP_HIST.observe(time.perf_counter() - t0, outcome="miss")
            return None
        loaded = self._load_entry(path)
        if loaded is None:
            self.disk_misses += 1
            _STORE_COUNTS["disk_misses"] += 1
            _LOOKUP_HIST.observe(time.perf_counter() - t0, outcome="miss")
            return None
        self.disk_hits += 1
        _STORE_COUNTS["disk_hits"] += 1
        _LOOKUP_HIST.observe(time.perf_counter() - t0, outcome="hit")
        self._entries[key] = loaded[1]
        return loaded[1]

    def _put(self, key: tuple, value: tuple) -> bool:
        if not super()._put(key, value):
            return False
        self._persist(key, value)
        return True

    def _persist(self, key: tuple, value: tuple) -> None:
        digest = key_digest(key)
        path = self.entries_dir / (digest + ".fp")
        if path.exists():
            # another process won the race; keep its entry (first writer
            # wins) but verify determinism held
            existing = self._load_entry(path)
            if existing is not None:
                if not _entry_values_equal(existing[1], value):
                    _STORE_COUNTS["conflicts"] += 1
                return
            # existing blob was corrupt (now quarantined): rewrite below
        payload = pickle.dumps((key, value),
                               protocol=pickle.HIGHEST_PROTOCOL)
        _write_blob(path, payload, fault_token=digest)
        _STORE_COUNTS["writes"] += 1
        if self.max_entries is not None:
            self._evict()

    def _evict(self) -> None:
        entries = sorted(self.entries_dir.glob("*.fp"),
                         key=lambda p: (p.stat().st_mtime, p.name))
        while len(entries) > self.max_entries:
            victim = entries.pop(0)
            with _suppress():
                victim.unlink()
            _STORE_COUNTS["evictions"] += 1

    # -- introspection ---------------------------------------------------

    def disk_entries(self) -> int:
        """Number of (valid-or-not-yet-read) entry files on disk."""
        return sum(1 for _ in self.entries_dir.glob("*.fp"))

    def stats(self) -> dict[str, int]:
        out = super().stats()
        out.update(disk_entries=self.disk_entries(),
                   disk_hits=self.disk_hits, disk_misses=self.disk_misses,
                   quarantined=self.quarantined)
        return out


class SearchJournal:
    """Per-round checkpointing for ``search_until_converged`` (see
    ``docs/robustness-guide.md`` for the resume semantics)."""

    STATE_VERSION = 1

    def __init__(self, root: str | os.PathLike, *, config: dict) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        config = dict(config, package=PACKAGE)
        self.config = config
        self.config_path = self.root / "config.json"
        self.journal_path = self.root / "journal.jsonl"
        if self.config_path.exists():
            try:
                existing = json.loads(self.config_path.read_text())
            except ValueError:
                existing = None
            if (isinstance(existing, dict)
                    and existing.get("package") != PACKAGE):
                raise ValueError(
                    f"checkpoint {self.root} was written by "
                    f"{existing.get('package', 'repro')!r}, not "
                    f"{PACKAGE!r}: its state blobs are not read here "
                    f"({self.config_path})")
            if existing is not None and existing != config:
                raise ValueError(
                    "checkpoint config mismatch: this directory belongs to "
                    "a search with different arguments — resuming it would "
                    f"not reproduce that run ({self.config_path})")
        else:
            _write_blob(self.config_path.with_suffix(".bin"),
                        json.dumps(config, sort_keys=True).encode())
            # the .json twin is for humans; the checksummed .bin is
            # authoritative only in that it survives torn writes — the
            # comparison above tolerates a missing/torn .json
            self.config_path.write_text(
                json.dumps(config, sort_keys=True, indent=1) + "\n")

    def _state_path(self, round_: int) -> Path:
        return self.root / f"state_r{round_:04d}.pkl"

    def save_round(self, round_: int, state: dict) -> None:
        """Atomically persist the end-of-round state and append the
        human-readable journal line.  The state blob is the commit point;
        a crash while appending the journal line costs nothing on resume
        (state discovery globs the blobs, the journal is informational)."""
        state = dict(state, version=self.STATE_VERSION, round=round_)
        payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        _write_blob(self._state_path(round_), payload)
        line = {"round": round_,
                "hypervolume": state.get("hypervolume"),
                "frontier_size": state.get("frontier_size"),
                "points_evaluated": state.get("points_evaluated"),
                "converged": state.get("converged"),
                "state_sha256": hashlib.sha256(payload).hexdigest()}
        with open(self.journal_path, "a") as f:
            f.write(json.dumps(line, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def load_latest(self) -> dict | None:
        """The newest *valid* checkpoint state, or None for a fresh start.
        A torn newest blob (killed mid-checkpoint) is quarantined and the
        previous round used — resume never trusts an unverified blob."""
        for path in sorted(self.root.glob("state_r*.pkl"), reverse=True):
            payload = _read_blob(path)
            if payload is not None:
                try:
                    state = pickle.loads(payload)
                except Exception:
                    state = None
                if (isinstance(state, dict)
                        and state.get("version") == self.STATE_VERSION):
                    return state
            with _suppress():
                os.replace(path, path.with_suffix(".pkl.corrupt"))
            _STORE_COUNTS["quarantined"] += 1
        return None

    def rounds_on_disk(self) -> int:
        return sum(1 for _ in self.root.glob("state_r*.pkl"))
