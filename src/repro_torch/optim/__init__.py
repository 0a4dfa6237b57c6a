"""Optimizers: AdamW and Adafactor (for >=100B MoE memory budgets),
gradient clipping, the cosine schedule.

Counterpart of ``repro/optim``, over a dict of named tensors (for a model,
``dict(params.named_parameters())``) where the JAX package takes a pytree.
``zero1_specs`` (optimizer-state sharding specs) belongs to the distributed
runtime and is not ported yet."""
from .adafactor import adafactor_init, adafactor_update
from .adamw import adamw_init, adamw_update
from .common import clip_by_global_norm, cosine_schedule

__all__ = ["adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "clip_by_global_norm", "cosine_schedule"]
