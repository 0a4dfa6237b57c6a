"""Baseline execution (the "default tool flow" of the paper's comparison):
no floorplan, every layer split over the FULL model axis (tensor
parallel), data parallelism over (pod, data) with ZeRO-1 optimizer
sharding (``repro_torch.launch.steps``).

Counterpart of ``repro/distributed/baseline.py``, where GSPMD places the
arrays; here a rank holds its shards (``placements``) and runs the layers
of ``tensor_parallel`` on them.  Serving runs data-parallel for every
family and head-parallel for the G and L layers; the context-parallel
cache split (the KV cache's length over the model axis) waits for ROADMAP
item 8c.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.model import lm
from . import tensor_parallel as tpar
from .collectives import Axis
from .pipeline import param_specs

DATA_AXES = ("pod", "data")


def data_axes(mesh) -> tuple[str, ...]:
    """The data axes, (pod, data) where present, of a ``DeviceMesh`` or a
    dict {axis: size}."""
    return tuple(a for a in DATA_AXES if a in axis_sizes(mesh))


def placements(cfg: ArchConfig, params, mesh) -> dict:
    """{parameter name: placement} of the baseline layout on ``mesh`` (a
    ``DeviceMesh`` or a dict {axis: size}): the reference's
    ``make_shardings``, each layer split over the whole "model" axis."""
    return param_specs(cfg, params, tp_axis="model",
                       tp_size=axis_sizes(mesh)["model"])


def batch_rows(n: int, data: Axis) -> slice:
    """The rows of a batch of ``n`` this data rank takes: its 1/data of
    them, or all of them where the data size does not divide ``n`` (the
    reference then replicates the batch)."""
    if data.size == 1 or n % data.size:
        return slice(0, n)
    per = n // data.size
    return slice(data.rank * per, (data.rank + 1) * per)


def build_loss(cfg: ArchConfig, tp: Axis, data: Axis):
    """``loss_fn(params, batch)``: chunked cross entropy + 0.01 aux over a
    rank's params and its rows of a microbatch (B, S + 1), each layer
    group recomputed in the backward.  Averaged over the
    data ranks, the loss and its gradients are the whole microbatch's."""
    def loss_fn(params, batch):
        tokens = batch["tokens"]
        x_tokens, targets = tokens[:, :-1], tokens[:, 1:]
        x = tpar.embed(params, cfg, x_tokens, tp)
        layers = tpar.Layers(
            params, cfg, torch.arange(x_tokens.shape[1], device=x.device),
            x0=x, memory=lm._memory(params, cfg, batch.get("extra")), tp=tp,
            data=data)
        x, aux = tpar.apply_layers(layers, len(params.layers), x)
        return tpar.chunked_ce(params, cfg, x, targets, tp) + 0.01 * aux

    return loss_fn


def build_serve_step(cfg: ArchConfig, tp: Axis):
    """``serve_step(params, cache, tokens)``: ``lm.step`` over a rank's
    params and cache (its rows, its heads) -> (the last position's logits
    over the whole padded vocab, gathered over tp; the cache, updated in
    place)."""
    tpar.check_tp(cfg, tp.size)
    data = Axis(None, 1, 0)

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        S = tokens.shape[1]
        pos = cache["pos"]
        x0 = x = tpar.embed(params, cfg, tokens, tp)
        layers = tpar.Layers(params, cfg,
                             torch.arange(pos, pos + S, device=x.device),
                             x0=x0, memory=cache.get("memory"), tp=tp,
                             data=data)
        for i in range(len(params.layers)):
            x, _ = layers(i, x, cache=cache["layers"][i], pos=pos)
        out = tpar.logits(params, cfg, x[:, -1:], tp)[:, 0]
        cache["pos"] = pos + S
        return out, cache

    return serve_step


def cache_shardings(cfg: ArchConfig, cache, mesh, *, kv_shard: str = "heads"):
    """The placement of each leaf of a cache (``lm.init_cache``'s
    structure: one dict a layer, no stack dim), the reference's rules: KV
    caches batch over (pod, data) and heads over model where the KV heads
    divide, else (or with ``kv_shard="context"``) the cache LENGTH over
    model (context parallelism); SSM states batch over data and heads over
    model; an entry that does not divide its dim is dropped.  ``mesh`` is
    a ``DeviceMesh`` or a dict {axis: size}."""
    if kv_shard not in ("heads", "context"):
        raise ValueError(f"kv_shard {kv_shard!r}: 'heads' or 'context'")
    sizes = axis_sizes(mesh)
    daxes = data_axes(sizes)
    tp = sizes["model"]

    def cut(spec, nd):
        return tuple(spec[:nd]) + (None,) * max(0, nd - len(spec))

    def axsize(entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in names:
            n *= sizes[a]
        return n

    def spec(name, shape):
        nd = len(shape)
        if nd == 0:
            return ()
        if name in ("k", "v"):            # (B, W, Hkv, D)
            if kv_shard == "context" and shape[1] % tp == 0:
                return cut((daxes, "model", None, None), nd)
            if shape[2] % tp == 0:
                return cut((daxes, None, "model", None), nd)
            if shape[1] % tp == 0:       # context parallelism fallback
                return cut((daxes, "model", None, None), nd)
            return cut((daxes, None, None, None), nd)
        if name in ("ssd", "wkv"):        # (B, H, P, N) / (B, H, D, D)
            if shape[1] % tp == 0:
                return cut((daxes, "model", None, None), nd)
            return cut((daxes, None, None, None), nd)
        if name == "conv":                # (B, K-1, C)
            if shape[2] % tp == 0:
                return cut((daxes, None, "model"), nd)
            return cut((daxes, None, None), nd)
        if name in ("tm_shift", "cm_shift"):
            return cut((daxes, None, None), nd)
        if name == "memory":
            return cut((daxes,), nd)
        return (None,) * nd

    def fit(sp, shape):
        return tuple(None if p is not None and shape[i] % axsize(p) else p
                     for i, p in enumerate(sp))

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        if tree is None:
            return None
        shape = tuple(getattr(tree, "shape", ()))
        return fit(spec(name, shape), shape)

    return walk(cache, "")


def check_cache_split(cfg: ArchConfig, cache_specs) -> None:
    """Raise ``NotImplementedError`` (naming 8c) where a placement splits
    a KV cache's length over the model axis: serving runs head-parallel
    only."""
    for layer in cache_specs["layers"]:
        for part in (layer, layer.get("attn")):
            if isinstance(part, dict) and "k" in part and \
                    len(part["k"]) > 1 and part["k"][1] == "model":
                raise NotImplementedError(
                    f"{cfg.name}: a context-parallel KV cache (its length "
                    f"over the model axis) waits for {tpar.ITEM_8C}")
