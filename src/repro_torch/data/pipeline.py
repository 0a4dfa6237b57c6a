"""Token data pipeline: synthetic + memmap-backed sources with a sharded,
background-prefetching loader.

The port's copy of ``repro/data/pipeline.py`` (NumPy and a thread, no
JAX): the same batches for the same seed, shard and step.  One addition:
``ShardedLoader(start=...)`` begins at a given step, so a run resumed from
a checkpoint at step N reads batch N next, as the unbroken run did.

Production layout: each data-parallel host reads its own shard (shard =
host index over the (pod, data) axes — the floorplanner binds data_in
tasks to ingest slots the same way it binds HBM channels).  Prefetch
runs in a thread so host IO overlaps device compute.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTokens:
    """Deterministic synthetic corpus: mixture of Zipfian unigrams and
    shifted repeats, so language models actually have something to learn
    (loss decreases measurably within a few hundred steps)."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, shard: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        probs /= probs.sum()
        toks = rng.choice(self.vocab, size=(batch, seq + 1), p=probs)
        # inject learnable structure: second half repeats the first half
        half = (seq + 1) // 2
        toks[:, half:half * 2] = toks[:, :half]
        return toks.astype(np.int32)


class MemmapTokens:
    """Flat uint16/uint32 token file, memory-mapped; shard-strided reads."""

    def __init__(self, path: str, vocab: int, dtype=np.uint16, seed: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, shard: int, batch: int, seq: int) -> np.ndarray:
        n = len(self.data) - (seq + 1)
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        starts = rng.integers(0, n, size=batch)
        return np.stack([self.data[s:s + seq + 1] for s in starts]) \
            .astype(np.int32)


class ShardedLoader:
    """Background prefetch of per-shard batches, from step ``start`` on."""

    def __init__(self, source, *, shard: int, batch: int, seq: int,
                 prefetch: int = 2, start: int = 0):
        self.source, self.shard, self.batch, self.seq = \
            source, shard, batch, seq
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            b = self.source.batch(step, self.shard, self.batch, self.seq)
            while not self._stop.is_set():
                try:
                    self.q.put(b, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
