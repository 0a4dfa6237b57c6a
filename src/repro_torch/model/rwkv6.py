"""RWKV-6 (Finch) block: time-mix (the WKV recurrence with data-dependent
decay) and channel-mix, attention-free.

Counterpart of ``repro/model/rwkv6.py``, with its parameter names and
layouts.  The recurrence routes through
``repro_torch.kernels.ops.rwkv6_scan``.  As in the JAX package the decay
LoRA runs in f32 and the decay is cast to the activation dtype just before
the scan; ``ln_x`` is an RMSNorm over the whole d_model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from .layers import RMSNorm, _f32, _weight, sigmoid, silu

#: rank of the decay LoRA
LORA = 64


def _token_shift(x, last):
    """concat(last, x[:, :-1]); last: (B, 1, d), the previous token."""
    return torch.cat([last, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu[None, None]


class TimeMix(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        self.mu = _weight((5, d), device)     # token-shift mix for r,k,v,w,g
        self.wr = _weight((d, d), device)
        self.wk = _weight((d, d), device)
        self.wv = _weight((d, d), device)
        self.wg = _weight((d, d), device)
        self.w_base = _f32((d,), device)
        self.w_A = _weight((d, LORA), device)
        self.w_B = _weight((LORA, d), device)
        self.u = _f32((d // cfg.ssm_head_dim, cfg.ssm_head_dim), device)
        self.wo = _weight((d, d), device)
        self.ln_x = RMSNorm(d, device)

    def forward(self, x, cfg: ArchConfig, shift, state):
        """x: (B, S, d); shift: (B, 1, d) last token of the previous call;
        state: (B, H, D, D) f32 or None.  Returns (y, new_shift,
        new_state)."""
        B, S, d = x.shape
        D = cfg.ssm_head_dim
        H = d // D
        xs = _token_shift(x, shift)
        r = (_mix(x, xs, self.mu[0]) @ self.wr).view(B, S, H, D)
        k = (_mix(x, xs, self.mu[1]) @ self.wk).view(B, S, H, D)
        v = (_mix(x, xs, self.mu[2]) @ self.wv).view(B, S, H, D)
        g = silu(_mix(x, xs, self.mu[3]) @ self.wg)
        w_raw = self.w_base[None, None] + torch.tanh(
            _mix(x, xs, self.mu[4]).float() @ self.w_A.float()) \
            @ self.w_B.float()
        w = torch.exp(-torch.exp(w_raw)).view(B, S, H, D)   # decay in (0,1)
        y, new_state = ops.rwkv6_scan(r, k, v, w.to(r.dtype), self.u, state)
        y = self.ln_x(y.reshape(B, S, d)) * g
        return y @ self.wo, x[:, -1:], new_state


class ChanMix(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        self.mu = _weight((2, d), device)
        self.wk = _weight((d, cfg.d_ff), device)
        self.wv = _weight((cfg.d_ff, d), device)
        self.wr = _weight((d, d), device)

    def forward(self, x, shift):
        xs = _token_shift(x, shift)
        k = torch.square(F.relu(_mix(x, xs, self.mu[0]) @ self.wk))
        r = sigmoid(_mix(x, xs, self.mu[1]) @ self.wr)
        return r * (k @ self.wv), x[:, -1:]


class RWKV6(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.time_mix = TimeMix(cfg, device)
        self.chan_mix = ChanMix(cfg, device)


def rwkv6_cache_init(cfg: ArchConfig, batch, device, dtype):
    """Token shifts in the activation dtype, the WKV state in f32."""
    d = cfg.d_model
    D = cfg.ssm_head_dim
    return {
        "tm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, d // D, D, D), dtype=torch.float32,
                           device=device),
    }
