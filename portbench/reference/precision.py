"""How the reference multiplies: ``F32`` (the reference itself) or
``FP8``, the control, one precision below the bf16 the configurations
state.

``FP8`` rounds both operands of every product to float8 with one scale
per tensor (amax to the format's largest finite), as fp8 training and
serving recipes do: e4m3 for weights and activations, e5m2 for the
gradients of the backward's two products.  The products themselves
accumulate in f32, and everything between them stays f32, so the control
differs from the reference only by the fp8 rounding of the operands.
"""
from __future__ import annotations

import torch


class F32:
    @staticmethod
    def mm(a, b):
        return a @ b


def _q8(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """x rounded to ``fmt`` at one scale, back in x's dtype."""
    top = torch.finfo(fmt).max
    scale = top / x.detach().abs().amax().float().clamp(min=1e-30)
    return (x * scale).clamp(-top, top).to(fmt).to(x.dtype) / scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a, torch.float8_e4m3fn), _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class FP8:
    @staticmethod
    def mm(a, b):
        if b.dim() == 2 and a.dim() > 2:     # activations x a weight matrix
            lead = a.shape[:-1]
            return _Fp8Product.apply(a.reshape(-1, a.shape[-1]), b) \
                .view(*lead, b.shape[-1])
        return _Fp8Product.apply(a, b)

