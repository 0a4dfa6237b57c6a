"""The one traffic generator: token ids from a seed, by the parameters of
a traffic file (``traffic/<name>.json``).

Ids follow a Zipf law over the vocabulary (exponent ``zipf``), as token
frequencies in code and text do.  Training rows repeat their first half
in their second (``repeat_half``), as ``repro_torch.data.SyntheticTokens``
makes them, so that a model has something to learn; this is a frozen copy
of that arithmetic, with the same stream of numbers for a seed, a step and
a shard.  Every seed gives the same sizes; only the ids differ.  Serving
prompts are drawn on the device (``torch.multinomial`` from a seeded
generator), so that making a request costs the closed loop no host time.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _zipf(vocab: int, s: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks ** s
    return p / p.sum()


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng((seed * 1_000_003 + step) * 65_537 + shard)


class TrainTokens:
    """Training batches: ``batch(step, shard, batch, seq)`` -> (batch,
    seq + 1) int32, the interface of the program's ``ShardedLoader``
    sources."""

    def __init__(self, vocab: int, seed: int, traffic: dict):
        self.vocab, self.seed = vocab, seed
        self.s = traffic["zipf"]
        self.repeat_half = traffic["repeat_half"]

    def batch(self, step: int, shard: int, batch: int, seq: int):
        toks = _rng(self.seed, step, shard).choice(
            self.vocab, size=(batch, seq + 1), p=_zipf(self.vocab, self.s))
        if self.repeat_half:
            half = (seq + 1) // 2
            toks[:, half:half * 2] = toks[:, :half]
        return toks.astype(np.int32)


@functools.lru_cache(maxsize=8)
def _zipf_on(vocab: int, s: float, device: str) -> torch.Tensor:
    return torch.tensor(_zipf(vocab, s), dtype=torch.float32, device=device)


def prompts(vocab: int, seed: int, call: int, traffic: dict,
            device) -> torch.Tensor:
    """The prompts of serving call ``call``: (batch, prompt_len) int32 on
    ``device``, the same for the same seed, call and device."""
    B, P = traffic["batch"], traffic["prompt_len"]
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + call) % (1 << 63))
    ids = torch.multinomial(_zipf_on(vocab, traffic["zipf"], str(device)),
                            B * P, replacement=True, generator=gen)
    return ids.view(B, P).to(torch.int32)
