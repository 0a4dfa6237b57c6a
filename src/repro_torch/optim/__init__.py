"""Optimizers: AdamW and Adafactor (for >=100B MoE memory budgets),
gradient clipping, the cosine schedule.

Counterpart of ``repro/optim``, over a dict of named tensors (for a model,
``dict(params.named_parameters())``) where the JAX package takes a pytree.
``zero1_specs`` places the optimizer state of the distributed step
builders (``repro_torch.launch.steps``): AdamW's moments and Adafactor's
factored ones are sharded over the data ranks there, and Adafactor runs
on the reference's stacked layers (``adafactor.Stacks``)."""
from .adafactor import adafactor_init, adafactor_update
from .adamw import adamw_init, adamw_update
from .common import (clip_by_global_norm, cosine_schedule, zero1_dim,
                     zero1_specs)

__all__ = ["adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "clip_by_global_norm", "cosine_schedule",
           "zero1_dim", "zero1_specs"]
