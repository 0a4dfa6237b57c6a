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
              q_offset=0, kv_len=None, return_lse=False):
    """Prefill (Sq > 1) through ``flash_attention``, a single query token
    through ``decode_attention`` (which alone takes ``return_lse``)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, kv_len=kv_len)
    if q.shape[1] > 1:
        return _fa.flash_attention(q, k, v, **kw)
    return _fa.decode_attention(q, k, v, return_lse=return_lse, **kw)


def mamba2_scan(x, dt, A, B, C, state=None):
    return _m2.mamba2_scan(x, dt, A, B, C, state)


def rwkv6_scan(r, k, v, w, u, state=None):
    return _r6.rwkv6_scan(r, k, v, w, u, state)


def burst_gather(table, idx):
    return _bg.burst_gather(table, idx)


def moe_plan(group_ids, n_experts):
    """The plan the card's grouped matmuls share; None for CPU ids, whose
    plain ``moe_gmm`` takes none."""
    if group_ids.device.type == "cpu":
        return None
    return _gmm.plan(group_ids, n_experts)


def moe_gmm(x, w, group_ids, plan=None, *, rows=None):
    return _gmm.moe_gmm(x, w, group_ids, plan, rows=rows)
