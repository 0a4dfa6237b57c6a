"""Shared optimizer utilities: global-norm clipping and the cosine
schedule, as ``repro/optim/common.py`` computes them."""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch


def named(tensors) -> dict[str, torch.Tensor]:
    """A dict of named tensors, or the (name, tensor) pairs of
    ``named_parameters()``, as a dict."""
    return dict(tensors.items() if isinstance(tensors, dict) else tensors)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)), the norm
    taken in f32 over all of them.  Returns (clipped grads by name, the
    norm as an f32 0-d tensor).  Each clipped gradient is a new tensor in
    its own dtype: g.float() * scale, rounded once."""
    grads = named(grads)
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return ({k: (g.float() * scale).to(g.dtype) for k, g in grads.items()},
            gn)


@functools.lru_cache(maxsize=None)
def _cosf():
    """The C library's single-precision ``cosf``: XLA's CPU backend calls
    it for an f32 cosine, and NumPy's and PyTorch's own float32 cosines
    differ from it in the last bit on some inputs."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def cosine_schedule(step, *, peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> float:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor_frac * peak`` at ``total``.

    Computed in np.float32 op by op as the JAX package computes it in f32,
    with its Python-float constants rounded to f32 where JAX casts them and
    the cosine taken by ``cosf``, as XLA takes it on the CPU; returns the f32 value as a Python float (exactly representable, so a
    product with an f32 tensor rounds as the JAX package's does)."""
    f32 = np.float32
    step = f32(step)
    if step < warmup:
        return float(f32(peak) * step / f32(max(warmup, 1)))
    prog = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                   f32(0), f32(1))
    cos = f32(1) + f32(_cosf()(f32(math.pi) * prog))
    return float(f32(peak) * (f32(floor_frac)
                              + f32((1 - floor_frac) * 0.5) * cos))
