"""Dispatch over the kernels of the serving path.

Counterpart of ``repro/kernels/ops.py``, without its environment switch:
each wrapper picks by the device of its tensors (the plain PyTorch version
on the CPU, the hand-written CUDA kernel on the card), so on the card the
model always runs the kernels.
"""
from __future__ import annotations

from . import burst_gather as _bg
from . import flash_attention as _fa
from . import mamba2_scan as _m2
from . import moe_gmm as _gmm
from . import rwkv6_scan as _r6


def attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
              q_offset=0, kv_len=None):
    """Prefill (Sq > 1) through ``flash_attention``, a single query token
    through ``decode_attention``."""
    fn = _fa.flash_attention if q.shape[1] > 1 else _fa.decode_attention
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              scale=scale, q_offset=q_offset, kv_len=kv_len)


def mamba2_scan(x, dt, A, B, C, state=None):
    return _m2.mamba2_scan(x, dt, A, B, C, state)


def rwkv6_scan(r, k, v, w, u, state=None):
    return _r6.rwkv6_scan(r, k, v, w, u, state)


def burst_gather(table, idx):
    return _bg.burst_gather(table, idx)


def moe_gmm(x, w, group_ids):
    return _gmm.moe_gmm(x, w, group_ids)
