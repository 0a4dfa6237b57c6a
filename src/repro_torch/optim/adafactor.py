"""Adafactor: a factored second moment and no first moment, ~2.6 B/param,
the optimizer of the largest MoE configuration (arctic-480b).

Counterpart of ``repro/optim/adafactor.py``; like ``adamw`` it updates the
parameters and the state in place and returns them.

The JAX package keeps a layer's parameters stacked, (G, ...) in the
baseline layout and (S, Gs, ...) in the pipeline layout
(``repro/launch/steps.py``), and runs Adafactor on those stacked leaves.
The port keeps each layer's parameters apart; ``Stacks`` names the ones
that form one of the reference's stacked leaves (the step builders take
them from ``model.convert.layer_stacks``), and the update then does what
the reference does to the stack:

  * the RMS clip is taken over the whole stack, every layer at one
    pattern position (all stages' in the pipeline layout);
  * a per-layer vector (d,), stacked (G, d) or (S, Gs, d), is factored:
    vr one layer's mean of g^2, vc the mean over the stack's layers (the
    stage's layers in the pipeline layout), and vr's mean over those same
    layers in the denominator;
  * a per-layer scalar is unfactored in the baseline layout (the stack is
    (G,)) and factored in the pipeline layout ((S, Gs)): vr the mean over
    the stage's layers, vc the mean over the stages.

Matrices and expert stacks keep their factoring per layer; only their
clip crosses layers.  With no ``Stacks`` every leaf is its own, as the
reference treats a flat dict of leaves.

Sharded (``repro_torch.launch.steps``), each leaf is this rank's piece
(``Held``: the dim cut over tp with each entry's weight, 1 / the tp ranks
that hold it, and the dim of its ZeRO-1 slice over the data ranks), and
each mean and RMS that crosses a sharded dim, or a stack's layers on
other stages, is a weighted sum over a weighted count, both summed over
the ranks that hold the rest through ``reduce``.  A replicated piece is
counted once.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import NamedTuple

import torch

from .common import named


class Held(NamedTuple):
    """How this rank holds a leaf: ``tp_dim``, the dim cut over the tp
    ranks (None: whole on each), with ``tp_weight`` the weight of each of
    its entries along it (1 / the ranks that hold the entry); and
    ``data_dim``, the dim of its ZeRO-1 slice over the data ranks (None:
    whole on each)."""
    tp_dim: int | None = None
    tp_weight: torch.Tensor | None = None
    data_dim: int | None = None


@dataclasses.dataclass(frozen=True)
class Stacks:
    """The leaves that form one of the reference's stacked leaves, each
    stack's names in layer order, and whether the layout is the
    pipeline's ((S, Gs, ...), a stage's layers here)."""
    groups: tuple[tuple[str, ...], ...] = ()
    pipeline: bool = False


#: ``reduce(tensors, axes)``: sum each tensor in place over the ranks of
#: the named axes ("tp", "data", "stage")
Reduce = Callable[[list, frozenset], None]


def _kind(shape, stacked: bool, pipeline: bool) -> str:
    """"matrix" (factored per layer), "vector" (a stacked per-layer
    vector), "scalar" (a per-layer scalar in the pipeline layout, factored
    across stages) or "full" (unfactored)."""
    if len(shape) >= 2:
        return "matrix"
    if stacked and len(shape) == 1:
        return "vector"
    if stacked and pipeline:
        return "scalar"
    return "full"


def _groups(params: dict, stacks: Stacks):
    """[(names, stacked)]: the stacks, then every other leaf alone."""
    seen, out = set(), []
    for names in stacks.groups:
        names = tuple(n for n in names if n in params)
        if names:
            out.append((names, True))
            seen.update(names)
    out += [((n,), False) for n in params if n not in seen]
    return out


def adafactor_init(params, stacks: Stacks | None = None) -> dict:
    """{"v": {name: {"vr", "vc"} or {"v"}}, "step": int32 0}, all f32
    zeros: a matrix's rows and columns (of the piece this rank holds); a
    stacked per-layer vector's vr (0-d) and vc (its shape), a per-layer
    scalar's vr and vc (0-d) in the pipeline layout; else the full
    moment."""
    params = named(params)
    stacks = stacks or Stacks()
    dev = next(iter(params.values())).device
    z = dict(dtype=torch.float32, device=dev)
    out = {}
    for names, stacked in _groups(params, stacks):
        for n in names:
            shape = tuple(params[n].shape)
            kind = _kind(shape, stacked, stacks.pipeline)
            if kind == "matrix":
                out[n] = {"vr": torch.zeros(shape[:-1], **z),
                          "vc": torch.zeros(shape[:-2] + shape[-1:], **z)}
            elif kind == "vector":
                out[n] = {"vr": torch.zeros((), **z),
                          "vc": torch.zeros(shape, **z)}
            elif kind == "scalar":
                out[n] = {"vr": torch.zeros((), **z),
                          "vc": torch.zeros((), **z)}
            else:
                out[n] = {"v": torch.zeros(shape, **z)}
    return {"v": out, "step": torch.zeros((), dtype=torch.int32, device=dev)}


class _Sums:
    """Partial sums to be summed over ranks, grouped by their axes."""

    def __init__(self, reduce: Reduce | None):
        self.reduce, self.items = reduce, {}

    def add(self, t, axes):
        if axes and self.reduce is not None:
            self.items.setdefault(frozenset(axes), []).append(t)
        return t

    def run(self):
        for axes, tensors in self.items.items():
            self.reduce(tensors, axes)
        self.items = {}


def _partial(x, h: Held, dims: tuple, sums: _Sums):
    """(the sum of x over ``dims``, the count of its entries), each
    weighted by ``h``'s tp weights where the tp dim is summed, queued to
    be summed over the axes whose ranks hold the rest of those dims."""
    dims = tuple(d % x.dim() for d in dims)
    count = torch.ones((), dtype=torch.float32, device=x.device)
    for d in dims:
        if d != h.tp_dim:
            count = count * x.shape[d]
    axes = set()
    if h.tp_dim is not None and h.tp_dim in dims:
        shape = [1] * x.dim()
        shape[h.tp_dim] = -1
        w = h.tp_weight.to(x.dtype)
        x = x * w.view(shape)
        count = count * w.sum()
        axes.add("tp")
    if h.data_dim is not None and h.data_dim in dims:
        axes.add("data")
    s = x.sum(dims) if dims else x
    return sums.add(s, axes), sums.add(count, axes), axes


@torch.no_grad()
def adafactor_update(params, grads, state, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, stacks: Stacks | None = None,
                     held: dict | None = None,
                     reduce: Reduce | None = None):
    """One Adafactor step, op by op as the JAX package's in f32 on its
    stacked leaves (``Stacks``; see the module's docstring): the row and
    column means of g^2 + eps (or the full second moment) decayed at beta
    = 1 - step^-decay, the update g / sqrt(v), clipped to RMS
    ``clip_threshold`` over the stack, and p - lr * u rounded once to the
    parameter's dtype.  ``held`` ({name: ``Held``}) and ``reduce`` take a
    rank's pieces of a sharded model.  Returns (params, state), both
    updated in place."""
    params, grads = named(params), named(grads)
    stacks = stacks or Stacks()
    held = held or {}
    pipe = stacks.pipeline
    step = state["step"] + 1
    beta = 1.0 - step.float() ** (-decay)
    groups = _groups(params, stacks)
    g = {n: grads[n].float() for n in params}
    g2 = {n: g[n] * g[n] + eps for n in params}
    hd = {n: held.get(n, Held()) for n in params}
    kinds = [_kind(tuple(params[names[0]].shape), stacked, pipe)
             for names, stacked in groups]

    # the means of g^2: rows and columns
    sums = _Sums(reduce)
    acc = []
    for (names, stacked), kind in zip(groups, kinds):
        h = hd[names[0]]
        if kind == "matrix":
            acc.append([(_partial(g2[n], h, (-1,), sums)[:2],
                         _partial(g2[n], h, (-2,), sums)[:2])
                        for n in names])
        elif kind == "vector":
            acc.append(([_partial(g2[n], h, (0,), sums)[:2] for n in names],
                        sum(g2[n] for n in names) / len(names)))
        elif kind == "scalar":
            n_stages = sums.add(torch.ones((), device=g2[names[0]].device),
                                {"stage"})
            acc.append((sum(g2[n] for n in names) / len(names),
                        [sums.add(g2[n].clone(), {"stage"}) for n in names],
                        n_stages))
        else:
            acc.append(None)
    sums.run()

    new = {}
    row_means = []
    for (names, stacked), kind, a in zip(groups, kinds, acc):
        v = state["v"]
        if kind == "matrix":
            means = []
            for n, ((rs, rc), (cs, cc)) in zip(names, a):
                vr = beta * v[n]["vr"] + (1 - beta) * (rs / rc)
                vc = beta * v[n]["vc"] + (1 - beta) * (cs / cc)
                new[n] = {"vr": vr, "vc": vc}
                # vr's mean over the rows, the parameter's dim -2
                nd, p = g2[n].dim(), hd[n]
                rows = Held(nd - 2 if p.tp_dim == nd - 2 else None,
                            p.tp_weight,
                            nd - 2 if p.data_dim == nd - 2 else None)
                means.append((_partial(vr, rows, (-1,), sums)[0], cc))
            row_means.append(means)
        elif kind == "vector":
            rows, col = a
            vc = beta * v[names[0]]["vc"] + (1 - beta) * col
            vrs = [beta * v[n]["vr"] + (1 - beta) * (rs / rc)
                   for n, (rs, rc) in zip(names, rows)]
            for n, vr in zip(names, vrs):
                new[n] = {"vr": vr, "vc": vc}
            row_means.append(sum(vrs) / len(vrs))
        elif kind == "scalar":
            row, cols, n_stages = a
            vr = beta * v[names[0]]["vr"] + (1 - beta) * row
            for n, c in zip(names, cols):
                new[n] = {"vr": vr,
                          "vc": beta * v[n]["vc"]
                          + (1 - beta) * (c / n_stages)}
            row_means.append((sums.add(vr.clone(), {"stage"}), n_stages))
        else:
            for n in names:
                new[n] = {"v": beta * v[n]["v"] + (1 - beta) * g2[n]}
            row_means.append(None)
    sums.run()

    # the updates and their RMS over each stack
    updates, rms_parts = [], []
    for (names, stacked), kind, m in zip(groups, kinds, row_means):
        us = []
        for i, n in enumerate(names):
            s = new[n]
            if kind == "matrix":
                mean = m[i][0] / m[i][1]
                denom = (s["vr"][..., None] * s["vc"][..., None, :]
                         / torch.clamp(mean[..., None, None], min=eps))
            elif kind == "vector":
                denom = s["vr"] * s["vc"] / torch.clamp(m, min=eps)
            elif kind == "scalar":
                denom = s["vr"] * s["vc"] / torch.clamp(m[0] / m[1],
                                                        min=eps)
            else:
                denom = s["v"]
            us.append(g[n] * torch.rsqrt(denom + eps))
        updates.append(us)
        total = torch.zeros((), dtype=torch.float32, device=us[0].device)
        count = torch.zeros((), dtype=torch.float32, device=us[0].device)
        axes = set()
        for n, u in zip(names, us):
            su, cu, ax = _partial(u * u, hd[n], tuple(range(u.dim())),
                                  _Sums(None))
            total, count, axes = total + su, count + cu, axes | ax
        if stacked:
            axes.add("stage")
        rms_parts.append((sums.add(total, axes), sums.add(count, axes)))
    sums.run()

    for (names, _), us, (total, count) in zip(groups, updates, rms_parts):
        rms = torch.sqrt(total / count)
        scale = torch.clamp(rms / clip_threshold, min=1.0)
        for n, u in zip(names, us):
            p = params[n]
            p.copy_(p.float() - lr * (u / scale))
            state["v"][n] = new[n]
    state["step"] = step
    return params, state
