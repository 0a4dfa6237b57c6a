"""Floorplanned pipeline runtime: GPipe-style ticks over a (stage, data,
tp) mesh, with per-boundary buffer depths from the latency balancer (the
realization of "pipeline every cross-slot stream, then balance", paper
§5).

Counterpart of ``repro/distributed/pipeline.py``.

Layout (``param_specs``, ``to_pipeline_params``): which dim of each of the
port's parameters (by name, per layer) is sharded over the tp axis (the
reference's rules, but for the mamba2 and rwkv6 leaves that the port cuts
by head, ``_BY_HEAD``; ``tensor_parallel.shard`` says how a dim is cut), and
which layers a stage holds: stage s the layer groups [s Gs, (s + 1) Gs),
i.e. layers [s Gs P, (s + 1) Gs P) of ``params.layers`` with P =
``len(cfg.layer_pattern)``.  Every other parameter (the embedding, the
final norm and head, zamba2's shared blocks, the frontend and whisper's
encoder) is held by every stage.

Runtime (``build_train_loss``):
  * one microbatch advances one stage a tick; microbatch m enters stage s
    at tick m + offs[s], offs the running sum of ``plan.boundary_depth``:
    a boundary of depth d delays its tensor by d ticks (the register
    analogue of a deep cross-pod edge);
  * every rank exchanges with its stage neighbours on every tick, zeros on
    the ticks its stage computes nothing, in one exchange that carries x
    and, for zamba2, the x0 skip stream with it; a stage computes only on
    the ticks whose microbatch is in [0, n_micro) (the reference's masked
    ``where`` gives those ticks no value and no gradient);
  * the memory stream (vision, audio) is computed on each stage from
    ``extra``;
  * the last stage computes the chunked cross entropy at once; full
    logits never travel;
  * the backward runs the exchanges in reverse, each sending its
    gradient back, in the same order on every rank (``collectives.
    exchange``); the step then sums the stage-shared parameters' gradients
    over the stage group, the transpose of the reference's
    ``broadcast_to``.

The MoE aux loss is divided by n_micro, as the baseline and ``lm.loss_fn``
divide it.  The reference divides it by n_micro x n_stages
(``repro/distributed/pipeline.py:242``), so its pipeline carries 1/S of the
aux term (ROADMAP §3).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.model import lm
from . import tensor_parallel as tpar
from .collectives import Axis, all_reduce, exchange
from .sharding import TpuPlan

# parameter-name -> which matmul dim shards over tp
_COL = ("wq", "wk", "wv", "w_up", "w_gate", "w_in", "wr", "wg", "w_A",
        "w_shared_in")
_ROW = ("wo", "w_down", "w_out", "w_B", "w_shared_out")


#: the port's own placements, where its mamba2 and rwkv6 layers split by
#: head (``tensor_parallel``'s docstring) and the reference's flat column
#: and row cuts would split a head's arithmetic across ranks: (module,
#: the name's tail) -> the dim cut over tp, or None for a whole tensor
_BY_HEAD = {("mamba", "conv_w"): 1, ("mamba", "A_log"): 0,
            ("mamba", "dt_bias"): 0, ("mamba", "D"): 0,
            ("mamba", "norm.w"): 0,
            ("time_mix", "w_A"): None, ("time_mix", "w_B"): 1,
            ("time_mix", "w_base"): 0, ("time_mix", "u"): 0,
            ("time_mix", "ln_x.w"): 0, ("chan_mix", "wv"): 0}


def _by_head(name: str):
    """(found, dim) of ``_BY_HEAD`` for a parameter name."""
    parts = name.split(".")
    for i, part in enumerate(parts):
        key = (part, ".".join(parts[i + 1:]))
        if key in _BY_HEAD:
            return True, _BY_HEAD[key]
    return False, None


def _leaf_spec(name: str, shape, *, tp_axis: str, tp_size: int,
               n_experts: int) -> tuple:
    """The placement of one parameter (a per-layer tensor, no stack
    dims, whole or a rank's shard): one entry a dim, ``tp_axis`` or None.
    The reference's rules, but for ``_BY_HEAD``'s parameters; the
    experts' by ``tensor_parallel.moe_placement`` of the model's
    ``n_experts``."""
    leaf = name.rsplit(".", 1)[-1]
    nd = len(shape)
    found, dim = _by_head(name)
    if found:
        return tuple(tp_axis if i == dim else None for i in range(nd))
    if leaf == "embed":
        return (tp_axis, None)
    if leaf == "lm_head":
        return (None, tp_axis)
    if leaf == "router":
        return (None,) * nd
    # MoE expert stacks (E, d, f): expert-parallel over tp when E divides,
    # otherwise the FFN dim
    if leaf in ("w_up", "w_down", "w_gate") and nd == 3:
        if tpar.moe_placement(n_experts, tp_size) == "expert":
            return (tp_axis, None, None)
        if leaf == "w_down":                # (E, f, d): shard f
            return (None, tp_axis, None)
        return (None, None, tp_axis)        # (E, d, f): shard f
    if leaf in _COL and nd >= 2:
        return (None,) * (nd - 1) + (tp_axis,)
    if leaf in _ROW and nd >= 2:
        return (tp_axis,) + (None,) * (nd - 1)
    return (None,) * nd


def _named_shapes(params) -> dict:
    """{name: shape} of an ``LM`` (any device) or of a dict of tensors or
    shapes."""
    items = params.named_parameters() if hasattr(params, "named_parameters") \
        else params.items()
    return {n: tuple(getattr(t, "shape", t)) for n, t in items}


def param_specs(cfg: ArchConfig, params, *, tp_axis: str = "model",
                tp_size: int = 16) -> dict:
    """{parameter name: placement} over the port's per-layer names.  The
    layout of the layers over stages is by index (``stage_layers``), so
    the baseline and the pipeline layouts differ only in ``tp_axis``."""
    return {n: _leaf_spec(n, s, tp_axis=tp_axis, tp_size=tp_size,
                          n_experts=cfg.n_experts or 1)
            for n, s in _named_shapes(params).items()}


def stage_layers(cfg: ArchConfig, n_stages: int, stage: int) -> range:
    """The layer indices stage ``stage`` holds: groups [s Gs, (s+1) Gs).
    One stage holds every layer, a last group cut short included."""
    if n_stages == 1:
        return range(cfg.n_layers)
    P = len(cfg.layer_pattern)
    n_groups = cfg.n_layers // P
    if n_groups * P != cfg.n_layers or n_groups % n_stages:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers in groups of "
                         f"{P} do not split over {n_stages} stages")
    per = n_groups // n_stages * P
    return range(stage * per, (stage + 1) * per)


def _layer_index(name: str):
    """(layer index, rest of the name) of a ``layers.<i>.…`` name, else
    None."""
    parts = name.split(".", 2)
    if parts[0] == "layers":
        return int(parts[1]), parts[2]
    return None


def to_pipeline_params(params: dict, cfg: ArchConfig, n_stages: int):
    """A dict of named tensors (a whole model's) -> one dict a stage: its
    layers renumbered from 0, and every parameter outside the layers."""
    out = []
    for s in range(n_stages):
        mine = stage_layers(cfg, n_stages, s)
        stage = {}
        for name, t in params.items():
            li = _layer_index(name)
            if li is None:
                stage[name] = t
            elif li[0] in mine:
                stage[f"layers.{li[0] - mine.start}.{li[1]}"] = t
        out.append(stage)
    return out


def from_pipeline_params(stages: list, cfg: ArchConfig) -> dict:
    """The inverse of ``to_pipeline_params``: the layers back at their
    indices; the parameters outside the layers from stage 0."""
    out = {}
    for s, stage in enumerate(stages):
        first = stage_layers(cfg, len(stages), s).start
        for name, t in stage.items():
            li = _layer_index(name)
            if li is not None:
                out[f"layers.{li[0] + first}.{li[1]}"] = t
            elif s == 0:
                out[name] = t
    return out


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ranks:
    """One rank's place on the mesh: its stage, data and tp axes; the tp
    ranks its attention splits over (``attn``: the rank's block of
    ``tensor_parallel.attn_split`` ranks, tp itself where the heads split
    over all of it) and those that share its KV head (``kv``,
    ``tensor_parallel.kv_share``)."""
    stage: Axis
    data: Axis
    tp: Axis
    kv: Axis
    attn: Axis


def offsets(plan: TpuPlan) -> list[int]:
    """The tick at which microbatch 0 enters each stage: the running sum
    of the boundary depths (depth 1 each where the plan has none)."""
    depths = plan.boundary_depth or [1] * (plan.n_stages - 1)
    offs = [0]
    for d in depths:
        offs.append(offs[-1] + int(d))
    return offs


def build_train_loss(cfg: ArchConfig, plan: TpuPlan, ranks: Ranks, *,
                     n_micro: int):
    """Returns ``loss_fn(params, batch) -> (objective, loss)`` running the
    floorplanned pipeline on this rank.  ``params`` is the rank's ``LM``
    (its stage's layers, split over tp); batch: {"tokens": (n_micro, mb,
    S + 1) this data rank's rows, optional "extra" of mb rows, the same
    for every microbatch}.  ``objective`` is this rank's part of the loss,
    whose ``backward()`` (on every rank of the mesh together) leaves each
    parameter's gradient of the whole pipeline's loss; ``loss`` is that
    loss, ce / n_micro + 0.01 aux / n_micro summed over the stages, with
    no gradient."""
    n_stages = plan.n_stages
    if ranks.stage.size != n_stages:
        raise ValueError(f"a plan of {n_stages} stages on a mesh of "
                         f"{ranks.stage.size}")
    offs = offsets(plan)
    s = ranks.stage.rank
    first, last = s == 0, s == n_stages - 1
    d_in = offs[s] - offs[s - 1] if s else 1
    n_local = len(stage_layers(cfg, n_stages, s))
    two = "H" in cfg.layer_pattern           # x0 travels with x

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        mb, seq = tokens.shape[1], tokens.shape[2] - 1
        dev = params.embed.device
        dtype = params.embed.dtype
        memory = tpar.memory(params, cfg, batch.get("extra"), ranks.tp,
                             ranks.attn)
        positions = torch.arange(seq, device=dev)
        payload = ((2,) if two else ()) + (mb, seq, cfg.d_model)
        order = torch.zeros((), device=dev, requires_grad=True)
        arrivals = {}
        ce = torch.zeros((), dtype=torch.float32, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(n_micro + offs[-1]):
            m = t - offs[s]
            send = None
            if 0 <= m < n_micro:
                if first:
                    x = x0 = tpar.embed(params, cfg, tokens[m][:, :-1],
                                        ranks.tp)
                else:
                    got = arrivals.pop(t)
                    x, x0 = (got[0], got[1]) if two else (got, None)
                # one applier a microbatch: the recomputation of a group in
                # the backward reads this microbatch's x0
                layers = tpar.Layers(params, cfg, positions, x0=x0,
                                     memory=memory, tp=ranks.tp,
                                     data=ranks.data, attn=ranks.attn)
                x, a = tpar.apply_layers(layers, n_local, x)
                aux = aux + a
                if last:
                    ce = ce + tpar.chunked_ce(params, cfg, x,
                                              tokens[m][:, 1:], ranks.tp)
                else:
                    send = torch.stack([x, x0]) if two else x
            if n_stages == 1:
                continue
            if send is None:
                send = torch.zeros(payload, dtype=dtype, device=dev)
            got, order = exchange(send, order, ranks.stage)
            if not first:
                arrivals[t + d_in] = got
        objective = (ce + 0.01 * aux) / n_micro + 0.0 * order
        loss = all_reduce(objective.detach(), ranks.stage)
        return objective, loss

    return loss_fn
