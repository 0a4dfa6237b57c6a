"""Carry the JAX package's weights across to the port.

``from_jax_params`` takes the tree that ``repro.model.lm.init_params``
returns, with every leaf converted to a numpy array by the caller, and
builds the port's ``LM``.  It imports no JAX: it takes numpy only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from .lm import LM, resolve_device


def _flatten(tree, prefix: str = ""):
    """(dotted name, leaf) for every leaf of nested dicts and lists; list
    entries are named by their index, as ``nn.ModuleList`` names them."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        if isinstance(value, (dict, list)):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def layer_name(cfg: ArchConfig, pos: int, group: int, rest: str) -> str:
    """The port's name of the JAX tree's ``groups[pos]`` leaf ``rest``,
    row ``group``: ``layers.{group * len(pattern) + pos}.{rest}``."""
    return f"layers.{group * len(cfg.layer_pattern) + pos}.{rest}"


def layer_stacks(cfg: ArchConfig, names) -> dict[tuple, list[str]]:
    """The port's parameter names that form one of the JAX tree's stacked
    ``groups`` leaves: {(pattern position, name within the layer): names
    in layer order}, the inverse of ``layer_name``.  Names outside
    ``layers`` (and a layer index's stage offset) are the caller's: a
    pipeline stage's layers, renumbered from 0, start at a group
    boundary, so their stacks are the stage's rows of the reference's."""
    P = len(cfg.layer_pattern)
    out: dict[tuple, list[tuple[int, str]]] = {}
    for name in names:
        parts = name.split(".", 2)
        if parts[0] != "layers" or len(parts) < 3:
            continue
        i = int(parts[1])
        out.setdefault((i % P, parts[2]), []).append((i, name))
    return {k: [n for _, n in sorted(v)] for k, v in out.items()}


@torch.no_grad()
def from_jax_params(tree: dict, cfg: ArchConfig, device="cuda",
                    dtype: torch.dtype | None = None) -> LM:
    """Build the port's parameters from the JAX package's tree.

    The stacked ``groups`` leaves (leading ``n_groups`` axis, one list entry
    per position in ``cfg.layer_pattern``) are split into per-layer
    tensors: layer ``n * len(pattern) + i`` takes ``groups[i][...][n]``;
    so an X position's stacked ``xattn_gate`` (n_groups,) becomes one 0-d
    f32 parameter a layer.  Other lists (zamba2's ``shared`` blocks,
    whisper's ``encoder``) are indexed by position:
    ``shared[1]["attn"]["wq"]`` becomes ``shared.1.attn.wq``; top-level
    leaves (``lm_head``, ``frontend_proj``, ``ln_enc``) keep their names.
    Weights keep their ``(d_in, d_out)`` layouts and their dtypes: bf16
    weights stay bf16 and f32 norm weights f32.  Leaves may be numpy arrays
    of any float dtype (bf16 leaves can come as float32: the widening and
    the cast back are exact).  With ``dtype`` every leaf takes that dtype
    instead (f32: a tree of f32 weights or gradients carried across
    unrounded).  ``device`` defaults to the card; with no GPU it raises
    unless the caller passes ``device="cpu"``.
    """
    params = LM(cfg, resolve_device(device))
    if dtype is not None:
        params.to(dtype)
    state = dict(_flatten({k: v for k, v in tree.items() if k != "groups"}))
    for i, group in enumerate(tree["groups"]):
        for name, leaf in _flatten(group):
            for n in range(leaf.shape[0]):
                state[layer_name(cfg, i, n, name)] = leaf[n]
    for name, p in params.named_parameters():
        if name not in state:
            raise KeyError(f"the JAX tree has no leaf for {name}")
        value = np.array(state.pop(name), dtype=np.float32)
        if value.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {value.shape} in the JAX tree, "
                             f"{tuple(p.shape)} in the port")
        p.copy_(torch.from_numpy(value).to(p.dtype))
    if state:
        raise ValueError(f"leaves the port does not use: {sorted(state)}")
    return params
