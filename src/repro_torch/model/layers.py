"""Core layers, in PyTorch: RMSNorm, rotary embeddings, GQA attention with
a KV cache, and the gated MLP.

Counterpart of ``repro/model/layers.py``.  Everything is bf16 with f32
norm weights and f32 norm/softmax internals.  Weights keep the JAX
package's ``(d_in, d_out)`` layouts, so a projection is ``x @ w`` as
there.  Attention routes through ``repro_torch.kernels.ops``.

Unlike the JAX package, which rebuilds its cache arrays, the attention
layer here writes k/v into the cache tensors in place, and the cache's
position counter is kept once, by ``lm.step``, outside the layers.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

PDTYPE = torch.bfloat16


def _weight(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=PDTYPE, device=device),
                        requires_grad=False)


def _f32(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps=1e-6):
    """f32 inside with an f32 weight, cast back to x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d, device):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                         device=device), requires_grad=False)

    def forward(self, x):
        return rmsnorm(x, self.w)


# ---------------------------------------------------------------------------
# activations, with the reference's rounding
# ---------------------------------------------------------------------------

def sigmoid(x):
    """``jax.nn.sigmoid``'s op graph, 1 / (1 + exp(-x)), each op rounding
    in x's dtype.  ``torch.sigmoid`` rounds once; in bf16 that alone moves
    the reduced zamba2's logits by up to 1e-2 against the JAX package."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x), rounding as ``sigmoid``."""
    return x * sigmoid(x)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def gelu(x):
    """``jax.nn.gelu(approximate=True)``'s op graph, each op rounding in
    x's dtype, its constants rounded to that dtype first, as JAX casts
    them.  ``F.gelu(approximate="tanh")`` rounds once: on 65,536 bf16
    values of 3 N(0, 1) it differs from JAX's on the CPU at 28,014 of
    them, by up to 1.6e-2 (tests/test_torch_layers.py)."""
    c = _rounded(math.sqrt(2 / math.pi), x.dtype)
    inner = c * (x + _rounded(0.044715, x.dtype) * x ** 3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions, dim, theta):
    """cos/sin tables: positions (...,) -> (..., dim//2), f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, style="neox"):
    """x: (B, S, H, D); cos/sin: (S, rot_dim//2) or (B, S, rot//2).

    "neox": rotate over the full head dim (half-split layout).
    "partial": chatglm-style 2d RoPE, rotary on the first half of the head
    dim only (interleaved pairs); the rest passes through.
    """
    if style in ("none", "learned"):
        return x
    D = x.shape[-1]
    rot = D if style == "neox" else D // 2
    xr, xp = x[..., :rot], x[..., rot:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]      # (1, S, 1, rot//2)
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    if style == "partial":
        x1 = xr[..., 0::2]
        x2 = xr[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(xr.shape)
    else:
        half = rot // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                            dim=-1)
    rotated = rotated.to(x.dtype)
    return torch.cat([rotated, xp], dim=-1) if rot < D else rotated


def rope_dim(cfg: ArchConfig) -> int:
    """Dims the rotary tables cover (the head dim, or half of it)."""
    return cfg.head_dim if cfg.rope_style == "neox" else cfg.head_dim // 2


# ---------------------------------------------------------------------------
# attention (GQA; optional sliding window / softcap)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttnSpec:
    """Static per-layer attention behaviour."""
    window: int | None = None
    softcap: float | None = None
    rope_theta: float = 10_000.0
    causal: bool = True


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.wq = _weight((d, qd), device)
        self.wk = _weight((d, kvd), device)
        self.wv = _weight((d, kvd), device)
        self.wo = _weight((qd, d), device)

    def forward(self, x, cfg: ArchConfig, spec: AttnSpec, rope, *,
                cache=None, pos: int = 0, kv_from=None):
        """x: (B, S, d); rope: (cos, sin) for positions pos..pos+S-1.

        cache: optional dict(k, v) of (B, W, Hkv, D) tensors, updated in
        place.  S > 1 with a cache is a prefill from position 0: full
        attention over the new tokens, then the last W tokens are stored
        ring-aligned (token t at slot t % W).  S == 1 is a decode step: k/v
        go to slot ``pos`` (``pos % W`` for windowed layers) and the query
        attends to the cache.

        kv_from: cross-attention memory (B, Sm, d).  k and v come from it,
        with no rope, no cache and no causal mask; ``rope`` is not read.
        As in the JAX package, they are recomputed at every step.
        """
        B, S, _ = x.shape
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        src = x if kv_from is None else kv_from
        Skv = src.shape[1]
        q = (x @ self.wq).view(B, S, H, D)
        k = (src @ self.wk).view(B, Skv, Hkv, D)
        v = (src @ self.wv).view(B, Skv, Hkv, D)
        if kv_from is None:
            cos, sin = rope
            q = apply_rope(q, cos, sin, cfg.rope_style)
            k = apply_rope(k, cos, sin, cfg.rope_style)
        scale = cfg.query_scale

        if cache is None or S > 1:
            out = ops.attention(q, k, v,
                                causal=spec.causal and kv_from is None,
                                window=spec.window, softcap=spec.softcap,
                                scale=scale)
        if cache is not None and S > 1:
            ck, cv = cache["k"], cache["v"]
            W = ck.shape[1]
            if S >= W:
                slots = (torch.arange(W, device=ck.device) + (S - W)) % W
                ck.zero_().index_copy_(1, slots, k[:, S - W:].to(ck.dtype))
                cv.zero_().index_copy_(1, slots, v[:, S - W:].to(cv.dtype))
            else:
                ck[:, :S] = k
                cv[:, :S] = v
        elif cache is not None:
            ck, cv = cache["k"], cache["v"]
            W = ck.shape[1]
            slot = pos if spec.window is None else pos % W
            # as jax.lax.dynamic_update_slice: the start is clamped so the
            # update fits
            slot = min(slot, W - S)
            ck[:, slot:slot + S] = k
            cv[:, slot:slot + S] = v
            if spec.window is None:
                out = ops.attention(q, ck, cv, causal=False,
                                    softcap=spec.softcap, scale=scale,
                                    q_offset=pos, kv_len=pos + S)
            else:
                # ring buffer: min(pos + S, W) valid entries, all of them
                # before the query, so no causal mask
                out = ops.attention(q, ck, cv, causal=False,
                                    softcap=spec.softcap, scale=scale,
                                    kv_len=min(pos + S, W))
        return out.reshape(B, S, H * D) @ self.wo


def attn_cache_init(cfg: ArchConfig, spec: AttnSpec, batch, max_seq, device,
                    dtype=PDTYPE):
    W = max_seq if spec.window is None else min(spec.window, max_seq)
    shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP (gated SiLU/GELU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, device, d_ff=None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        self.w_up = _weight((cfg.d_model, d_ff), device)
        self.w_down = _weight((d_ff, cfg.d_model), device)
        if cfg.gated_mlp:
            self.w_gate = _weight((cfg.d_model, d_ff), device)

    def forward(self, x, cfg: ArchConfig):
        act = silu if cfg.mlp_act == "silu" else gelu
        up = x @ self.w_up
        if cfg.gated_mlp:
            up = act(x @ self.w_gate) * up
        else:
            up = act(up)
        return up @ self.w_down
