"""Mamba-2 (SSD) block for the zamba2 hybrid architecture.

Counterpart of ``repro/model/mamba2.py``, with its parameter names and
layouts.  The scan routes through ``repro_torch.kernels.ops.mamba2_scan``.
Rounding follows the JAX package: the projections and the causal conv run
in the activation dtype (the conv rounds at every tap), ``dt`` and ``A``
stay f32, and the skip term ``y + x * D`` is taken in the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from .layers import RMSNorm, _f32, _weight, silu


def _causal_conv(x, w, state=None):
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C); state: (B, K-1,
    C) trailing context or None.  Summed tap by tap in x's dtype, in the
    JAX package's order.  Returns (out, new_state), the new state being the
    last K-1 rows of the pre-activation input."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+K-1, C)
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out, (xp[:, -(K - 1):] if K > 1 else None)


class Mamba2(nn.Module):
    """Parameters: ``w_in`` (d, 2 d_in + 2 N + H) fused [x, z, B, C, dt]
    projection, ``conv_w`` (K, d_in + 2 N), f32 ``A_log``, ``dt_bias``,
    ``D`` (H,), ``norm`` over d_in and ``w_out`` (d_in, d)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        H = d_in // cfg.ssm_head_dim
        N = cfg.ssm_state
        self.w_in = _weight((d, 2 * d_in + 2 * N + H), device)
        self.conv_w = _weight((cfg.ssm_conv, d_in + 2 * N), device)
        self.A_log = _f32((H,), device)
        self.dt_bias = _f32((H,), device)
        self.D = _f32((H,), device)
        self.norm = RMSNorm(d_in, device)
        self.w_out = _weight((d_in, d), device)

    def forward(self, x, cfg: ArchConfig, cache=None):
        """x: (B, S, d).  cache: dict(conv (B, K-1, C), ssd (B, H, P, N)
        f32) or None; its entries are replaced by the new states."""
        B, S, d = x.shape
        d_in = cfg.ssm_expand * d
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        H = d_in // P

        z, xin, Bc, Cc, dt = torch.split(x @ self.w_in,
                                         [d_in, d_in, N, N, H], dim=-1)
        conv_in = torch.cat([xin, Bc, Cc], dim=-1)          # (B, S, d_in+2N)
        conv_out, new_conv = _causal_conv(
            conv_in, self.conv_w, None if cache is None else cache["conv"])
        xin, Bc, Cc = torch.split(silu(conv_out), [d_in, N, N], dim=-1)

        dtp = F.softplus(dt.float() + self.dt_bias)
        A = -torch.exp(self.A_log)
        xh = xin.reshape(B, S, H, P)
        y, new_ssd = ops.mamba2_scan(xh, dtp, A, Bc, Cc,
                                     None if cache is None else cache["ssd"])
        y = y + xh * self.D[None, None, :, None].to(y.dtype)
        y = self.norm(y.reshape(B, S, d_in)) * silu(z)
        if cache is not None:
            cache["conv"], cache["ssd"] = new_conv, new_ssd
        return y @ self.w_out


def mamba2_cache_init(cfg: ArchConfig, batch, device, dtype):
    """The conv state in the activation dtype, the SSD state in f32."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             d_in + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }
