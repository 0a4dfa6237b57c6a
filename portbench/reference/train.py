"""Plain PyTorch reference of a training step: the loss of
``granite.loss``, its gradients by autograd, global-norm clipping and
AdamW, all in f32.

AdamW as the traffic file states it: m = b1 m + (1 - b1) g, v = b2 v + (1
- b2) g^2, the update (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) +
weight_decay * p on every leaf, p -= lr * update.  Clipping scales every
gradient by min(1, clip / max(norm, 1e-9)), the norm over all of them.
It imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import granite


def clip(grads: dict, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gn


@torch.no_grad()
def adamw(params: dict, grads: dict, state: dict, hp: dict) -> None:
    state["t"] += 1
    t, b1, b2 = state["t"], hp["b1"], hp["b2"]
    b1c, b2c = 1 - b1 ** t, 1 - b2 ** t
    for k, p in params.items():
        g = grads[k]
        m = state["m"][k].mul_(b1).add_((1 - b1) * g)
        v = state["v"][k].mul_(b2).add_((1 - b2) * g * g)
        u = (m / b1c) / (torch.sqrt(v / b2c) + hp["eps"]) \
            + hp["weight_decay"] * p
        p.sub_(hp["lr"] * u)


def run(m: dict, params: dict, batches, hp: dict, prec, *,
        fault: str | None = None) -> dict:
    """Train ``params`` (f32 leaves, changed in place) over ``batches``
    (each (B, S + 1) int64), one step a batch.  Returns each step's loss,
    each leaf's norm of the first step's clipped gradient, and each leaf's
    norm of its change over all the steps.  ``fault="half_batch"``: the
    loss takes the mean over the first half of the targets only."""
    start = {k: p.detach().to(torch.bfloat16) for k, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    state = {"t": 0, "m": {k: torch.zeros_like(p) for k, p in params.items()},
             "v": {k: torch.zeros_like(p) for k, p in params.items()}}
    out = {"losses": [], "grad_norms": {}, "change_norms": {}}
    for step, tokens in enumerate(batches):
        rows = None
        if fault == "half_batch":
            rows = tokens.shape[0] * (tokens.shape[1] - 1) // 2
        loss = granite.loss(params, m, tokens, prec, rows=rows)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        grads, _ = clip(grads, hp["clip"])
        if step == 0:
            out["grad_norms"] = {k: float(torch.linalg.vector_norm(g))
                                 for k, g in grads.items()}
        adamw(params, grads, state, hp)
        for p in params.values():
            p.grad = None
        out["losses"].append(float(loss.detach()))
        del loss, grads
    with torch.no_grad():
        for k, p in params.items():
            out["change_norms"][k] = float(torch.linalg.vector_norm(
                p - start[k].float()))
    if not all(math.isfinite(x) for x in out["losses"]):
        raise FloatingPointError(f"reference losses {out['losses']}")
    return out
