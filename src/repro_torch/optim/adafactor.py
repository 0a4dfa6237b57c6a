"""Adafactor: a factored second moment and no first moment, ~2.6 B/param,
the optimizer of the largest MoE configuration (arctic-480b).

Counterpart of ``repro/optim/adafactor.py``; like ``adamw`` it updates the
parameters and the state in place and returns them.
"""
from __future__ import annotations

import torch

from .common import named


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params) -> dict:
    """{"v": {name: {"vr": rows, "vc": columns} for a matrix (or stack of
    them), else {"v": full}}, "step": int32 0}, all f32 zeros."""
    params = named(params)
    dev = next(iter(params.values())).device

    def one(p):
        z = dict(dtype=torch.float32, device=dev)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    return {"v": {k: one(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(params, grads, state, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0):
    """One Adafactor step, op by op as the JAX package's in f32: the row
    and column means of g^2 + eps (or the full second moment for a
    vector) decayed at beta = 1 - step^-decay, the update g / sqrt(v),
    clipped to RMS ``clip_threshold``, and p - lr * u rounded once to the
    parameter's dtype.  Returns (params, state), both updated in place."""
    params, grads = named(params), named(grads)
    step = state["step"] + 1
    beta = 1.0 - step.float() ** (-decay)
    for k, p in params.items():
        gf = grads[k].float()
        g2 = gf * gf + eps
        v = state["v"][k]
        if _factored(p.shape):
            vr = beta * v["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * v["vc"] + (1 - beta) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
            u = gf * torch.rsqrt(denom + eps)
            state["v"][k] = {"vr": vr, "vc": vc}
        else:
            nv = beta * v["v"] + (1 - beta) * g2
            u = gf * torch.rsqrt(nv + eps)
            state["v"][k] = {"v": nv}
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p.copy_(p.float() - lr * u)
    state["step"] = step
    return params, state
