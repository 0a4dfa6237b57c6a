"""AdamW with bf16 params and f32 moments (10 B/param in all).

Counterpart of ``repro/optim/adamw.py``.  The JAX package returns new
trees; here each parameter and the state are updated in place (one
model's f32 moments are twice its bf16 weights, so a second copy of the
state would not fit where the first barely does), and returned too.
"""
from __future__ import annotations

import torch

from .common import named


def adamw_init(params) -> dict:
    """{"m": {name: f32 zeros}, "v": {name: f32 zeros}, "step": int32 0}."""
    params = named(params)
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step, op by op as the JAX package's in f32: the moments
    m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g g, the bias-corrected
    update (m / b1c) / (sqrt(v / b2c) + eps) plus weight_decay * p, and
    p - lr * u rounded once to the parameter's dtype.  ``lr`` is a Python
    float or an f32 0-d tensor.  Returns (params, state), both updated in
    place."""
    params, grads = named(params), named(grads)
    step = state["step"] + 1
    stepf = step.float()
    b1c = 1 - torch.tensor(b1, dtype=torch.float32,
                           device=stepf.device) ** stepf
    b2c = 1 - torch.tensor(b2, dtype=torch.float32,
                           device=stepf.device) ** stepf
    for k, p in params.items():
        gf = grads[k].float()
        m = state["m"][k].mul_(b1).add_((1 - b1) * gf)
        v = state["v"][k].mul_(b2).add_((1 - b2) * gf * gf)
        u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        u = u + weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    state["step"] = step
    return params, state
