"""Mixture-of-Experts FFN: top-k router and the experts' gated MLPs.

Counterpart of ``repro/model/moe.py``.  The parameters keep the JAX
package's names and layouts: ``router`` (d, E) in f32, ``w_up`` and
``w_gate`` (E, d, f) and ``w_down`` (E, f, d) in bf16.

The JAX package computes the experts as a dense masked einsum: every token
passes through all E experts and the experts it did not pick give exact
zeros.  Here the (token, k) pairs are sorted by expert and only the
T * top_k routed rows go through the grouped matmul ``ops.moe_gmm``:
the same function with 1/E of the rows.  The sums and roundings follow
the JAX package's: router logits, softmax and renormalisation in f32, the
expert matmuls accumulated in f32 and rounded to bf16, ``jax.nn.silu``'s
op graph, the combine weights rounded to bf16 and summed in f32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from .layers import _f32, _weight, silu


def route(router: torch.Tensor, cfg: ArchConfig, xf: torch.Tensor):
    """xf: (T, d) -> (probs (T, E) f32, top_p (T, k) f32 renormalised,
    top_i (T, k) int64), as ``moe_apply`` routes: f32 logits, softmax,
    top-k, renormalisation with a 1e-9 floor."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_i


def expert_counts(top_i: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) int64: the (token, k) pairs routed to each expert.  An integer
    scatter-add, exact in any order; ``torch.bincount`` would wait for the
    card to size its output."""
    flat = top_i.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat))


def aux_loss(probs: torch.Tensor, top_i: torch.Tensor, E: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Switch load-balance loss, E * sum_e (fraction routed to e * mean
    probability of e), f32.  The fraction is rounded to the activation
    dtype, as the JAX package's one-hot mean is."""
    T = top_i.shape[0]
    frac = (expert_counts(top_i, E).float() / max(T, 1)).to(dtype).float()
    return E * torch.sum(frac * probs.mean(0))


class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = _f32((d, e), device)
        self.w_up = _weight((e, d, f), device)
        self.w_down = _weight((e, f, d), device)
        if cfg.gated_mlp:
            self.w_gate = _weight((e, d, f), device)

    def forward(self, x, cfg: ArchConfig, aux_fn=None):
        """x: (B, S, d) -> (y (B, S, d) in x.dtype, aux loss f32).
        ``aux_fn`` takes ``aux_loss``'s place (the distributed runtime's
        takes it over every data-parallel rank's tokens)."""
        B, S, d = x.shape
        xf = x.reshape(B * S, d)
        probs, top_p, top_i = route(self.router, cfg, xf)
        y = experts(self, cfg, xf, top_p, top_i).to(x.dtype)
        aux = (aux_fn or aux_loss)(probs, top_i, cfg.n_experts, x.dtype)
        return y.view(B, S, d), aux


def experts(m: MoE, cfg: ArchConfig, xf, top_p, top_i, *, first: int = 0,
            rows: int | None = None):
    """The experts' weighted sum for tokens xf (T, d) routed to top_i
    with weights top_p: (T, d) f32, before its rounding to xf's dtype.
    ``m``'s experts are experts [first, first + E_m) of the model's (all
    of them by default): a (token, k) pair routed elsewhere gives a zero
    row (``moe_gmm``), so the caller sums the ranks' results.  ``rows``:
    the rows the shape-only path counts in its FLOPs (all T k by
    default)."""
    k = cfg.top_k
    # dispatch: the (token, k) pairs in expert order; a stable sort keeps
    # each expert's rows in token order
    flat = top_i.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ids = flat[order] - first if first else flat[order]
    xs = ops.burst_gather(xf, order // k)                     # (T k, d)

    # one stable plan of the ids serves the layer's three products
    plan = ops.moe_plan(ids, m.w_up.shape[0])
    kw = {} if rows is None else {"rows": rows}
    up = ops.moe_gmm(xs, m.w_up, ids, plan, **kw)
    if cfg.gated_mlp:
        up = silu(ops.moe_gmm(xs, m.w_gate, ids, plan, **kw)) * up
    else:
        up = silu(up)
    ys = ops.moe_gmm(up, m.w_down, ids, plan, **kw)          # (T k, d)

    # combine: back to (token, k) order through the inverse permutation (a
    # gather, so no atomics), weighted by the bf16 top_p, summed in f32
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    ye = ys.index_select(0, inv).view(-1, k, ys.shape[-1])
    p = top_p.to(xf.dtype).float()
    return (ye.float() * p[..., None]).sum(1)
