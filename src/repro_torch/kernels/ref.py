"""Plain PyTorch versions of the kernels on the serving path.

Counterpart of ``repro/kernels/ref.py`` (``attention_ref``,
``burst_gather_ref``), with the same signatures and layouts.  They are the
semantics contract: the CUDA kernels in ``csrc/`` are held to them on the
card, and the wrappers run them for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


def _per_batch(value, B: int, device) -> torch.Tensor:
    """An int or a (B,) tensor -> a (B,) int64 tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int64).reshape(-1) \
            .expand(B)
    return torch.full((B,), int(value), dtype=torch.int64, device=device)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None,
                  softcap: float | None = None,
                  scale: float | None = None,
                  q_offset: int | torch.Tensor = 0,
                  kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention with grouped KV heads.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] (decode: cache length), an int
    or a (B,) tensor.  ``kv_len``: optional valid KV length, an int or a
    (B,) tensor (ragged decode batches).  Returns (B, Sq, Hq, D) in q.dtype.
    Rows with no valid key give zeros.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale

    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)       # (B, Hq, Sq, Skv)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap

    qpos = (_per_batch(q_offset, B, q.device)[:, None]
            + torch.arange(Sq, device=q.device)[None, :])[:, :, None]
    kpos = torch.arange(Skv, device=q.device)[None, None, :]
    mask = torch.ones((B, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < _per_batch(kv_len, B, q.device)[:, None, None]
    mask = mask[:, None]                                    # (B, 1, Sq, Skv)
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def burst_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` at ``idx``: table (R, D), idx (N,) -> (N, D).

    Indices must lie in [0, R).  ``jnp.take`` in the JAX reference wraps
    negative indices and fills out-of-range rows with NaN; this version
    raises on both (``torch.index_select``), and the model only passes
    token ids below the vocabulary size.
    """
    return torch.index_select(table, 0, idx)
