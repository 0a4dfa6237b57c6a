"""The rule of the CUDA wrappers that have no backward kernel."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise if a gradient is wanted (grad mode on) of any of ``tensors``
    on the card: the kernel writes a fresh tensor that autograd cannot see
    through, so ``backward()`` would otherwise leave its inputs without a
    gradient and raise nothing."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel on CUDA yet; run with "
            f"torch.no_grad() or train this model on the CPU (device='cpu'), "
            f"where the plain version differentiates")
