"""Step builders: given (arch, shape cell, mesh) produce the distributed
train or serve step of one rank, with its placements and meta-device
stand-ins of every input.

Counterpart of ``repro/launch/steps.py`` on ``torch.distributed``: NCCL
with the card (the default), gloo on the CPU (``device="cpu"``).  Every
rank of the mesh's group builds the same step and calls it on the same
global batch; each takes its own rows and shards.

  * ``build_baseline_train``: tensor parallel over the mesh's "model"
    axis, data parallel over (pod, data); f32 gradients accumulated over
    ``n_micro`` microbatches, averaged over the data ranks, clipped to
    global norm 1 and applied by AdamW whose state is sharded over the
    data ranks (ZeRO-1: each data rank updates its slice, then the slices
    are gathered);
  * ``build_tapa_train``: the floorplanned pipeline
    (``distributed.pipeline``) on ``refined_mesh`` of a ``TpuPlan``, the
    same clip and optimizer;
  * ``build_baseline_serve``: prefill and decode through ``lm.step``'s
    arithmetic on a rank's rows and heads, the KV cache split by heads or
    by its length (``baseline.kv_mode``).

A step's ``args`` are meta-device stand-ins (``param_structs``,
``input_specs``), so that a step can be traced without memory.  Adafactor
(arctic-480b's) runs as the reference runs it on its stacked layers,
(G, ...) in the baseline's layout and (S, Gs, ...) in the pipeline's
(``optim.adafactor.Stacks``), its state sliced over the data ranks as
AdamW's is (ZeRO-1), each mean and RMS that crosses tp, the data slices
or the stages summed over the ranks that hold them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import baseline as bl
from repro_torch.distributed import pipeline as pp
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.distributed.collectives import (Axis, all_gather,
                                                 all_gather_object,
                                                 all_reduce, all_reduce_,
                                                 axis, sub_axis)
from repro_torch.distributed.sharding import TpuPlan, plan_cell, refined_mesh
from repro_torch.distributed.taskgraph import ShapeCell
from repro_torch.model import convert, lm
from repro_torch.model.layers import PDTYPE
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, zero1_dim, zero1_specs)
from repro_torch.optim.adafactor import Held, Stacks

N_MICRO = 8


def n_micro_for(cfg: ArchConfig) -> int:
    """Deeper microbatching for big models: the activations scale with
    1 / n_micro."""
    n = cfg.param_count()
    if n >= 100e9:
        return 32
    if n >= 20e9:
        return 16
    return N_MICRO


def input_specs(cfg: ArchConfig, cell: ShapeCell, *, mode: str = "baseline",
                n_micro: int = N_MICRO) -> dict:
    """Meta-device stand-ins for every model input: tokens (B, S + 1) for
    the baseline's training, (n_micro, B / n_micro, S + 1) for the
    pipeline's, (B, S) for a prefill, (B, 1) for a decode step; the stub
    frontend's inputs as ``extra`` (mb rows, shared by the microbatches,
    in the pipeline)."""
    B, S = cell.global_batch, cell.seq_len
    meta = dict(device="meta")
    if cell.kind == "train":
        if mode == "tapa":
            shape = (n_micro, max(B // n_micro, 1), S + 1)
        else:
            shape = (B, S + 1)
    elif cell.kind == "prefill":
        shape = (B, S)
    else:
        shape = (B, 1)
    batch = {"tokens": torch.empty(shape, dtype=torch.int32, **meta)}
    if cfg.family in ("vlm", "audio"):
        rows = shape[1] if mode == "tapa" and cell.kind == "train" else B
        key = "vision" if cfg.family == "vlm" else "frames"
        batch["extra"] = {key: torch.empty(
            (rows, cfg.frontend_tokens, cfg.frontend_dim), dtype=PDTYPE,
            **meta)}
    return batch


def param_structs(cfg: ArchConfig) -> lm.LM:
    """The model's parameters on the meta device."""
    return lm.LM(cfg, "meta")


def _opt_spec_tree(o_structs: dict, param_zspecs: dict) -> dict:
    """Optimizer-state placements mirroring its structure."""
    return {k: () if k == "step" else _mirror_specs(v, param_zspecs)
            for k, v in o_structs.items()}


def _mirror_specs(tree: dict, pspecs: dict) -> dict:
    """{name: placement} for a state dict by parameter name.  Adafactor's
    factored {vr, vc} take the placements of the parameter's dims they
    keep: vr its rows', vc its columns' (a stacked per-layer vector's vc
    the vector's; 0-d entries none).  (The reference's ``_mirror_specs``
    gives both the rows' placement, parts[:-1], which GSPMD then applies
    to vc's columns; the values do not depend on it.)"""
    out = {}
    for name, v in tree.items():
        parts = tuple(pspecs[name])
        if not isinstance(v, dict):
            out[name] = parts
            continue
        out[name] = {}
        for k, t in v.items():
            if k == "v" or (k == "vc" and t.dim() == len(parts)):
                out[name][k] = parts
            elif t.dim() == 0:
                out[name][k] = ()
            elif k == "vr":
                out[name][k] = parts[:-1]
            else:
                out[name][k] = parts[:-2] + parts[-1:]
    return out


def _batch_specs(cfg: ArchConfig, cell: ShapeCell, daxes, *, mode: str):
    if mode == "tapa" and cell.kind == "train":
        toks = (None, daxes, None)
    else:
        toks = (daxes, None)
    out = {"tokens": toks}
    if cfg.family in ("vlm", "audio"):
        key = "vision" if cfg.family == "vlm" else "frames"
        out["extra"] = {key: (daxes, None, None)}
    return out


# ---------------------------------------------------------------------------
# a rank's parameters
# ---------------------------------------------------------------------------

def _named(params) -> dict:
    return dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else dict(params)


def _shard_dim(spec: tuple, tp_axis: str):
    return spec.index(tp_axis) if tp_axis in spec else None


def shard_params(params, cfg: ArchConfig, *, stage: int = 0,
                 n_stages: int = 1, tp: Axis, tp_axis: str = "model",
                 device="cuda", requires_grad: bool = True) -> lm.LM:
    """A rank's ``LM`` from the whole model's parameters (an ``LM`` or a
    dict of named tensors, on any device): the layers of stage ``stage``
    (renumbered from 0) and every parameter outside the layers, each cut
    to this tp rank's shard (``tensor_parallel.shard``), copied to
    ``device``."""
    device = lm.resolve_device(device)
    mine = pp.to_pipeline_params(_named(params), cfg, n_stages)[stage]
    specs = pp.param_specs(cfg, mine, tp_axis=tp_axis, tp_size=tp.size)
    local = lm.LM(dataclasses.replace(cfg, n_layers=len(
        pp.stage_layers(cfg, n_stages, stage))), "meta")
    want = {n for n, _ in local.named_parameters()}
    if want != set(mine):
        raise ValueError(f"{cfg.name}: parameters {sorted(want ^ set(mine))}"
                         f" differ from the model's")
    for name, t in mine.items():
        dim = _shard_dim(specs[name], tp_axis)
        if dim is not None and tp.size > 1:
            t = tpar.shard(cfg, name, t, dim, tp)
        prefix, _, leaf = name.rpartition(".")
        mod = local.get_submodule(prefix) if prefix else local
        setattr(mod, leaf, nn.Parameter(
            t.detach().to(device, copy=True).contiguous(),
            requires_grad=requires_grad))
    return local


def _global_name(name: str, first: int) -> str:
    li = pp._layer_index(name)
    return name if li is None else f"layers.{li[0] + first}.{li[1]}"


@dataclasses.dataclass
class _Rank:
    """What the steps share: the config, this rank's axes and layout."""
    cfg: ArchConfig
    ranks: pp.Ranks
    n_stages: int
    tp_axis: str
    device: torch.device

    @property
    def first_layer(self) -> int:
        return pp.stage_layers(self.cfg, self.n_stages,
                               self.ranks.stage.rank).start

    def shard(self, params, requires_grad: bool = True) -> lm.LM:
        """This rank's ``LM`` (see ``shard_params``)."""
        return shard_params(params, self.cfg, stage=self.ranks.stage.rank,
                            n_stages=self.n_stages, tp=self.ranks.tp,
                            tp_axis=self.tp_axis, device=self.device,
                            requires_grad=requires_grad)

    def specs(self, params) -> dict:
        return pp.param_specs(self.cfg, params, tp_axis=self.tp_axis,
                              tp_size=self.ranks.tp.size)

    def gather(self, tensors: dict) -> dict:
        """The whole model's tensors (on the CPU, by the model's names)
        from every rank's ``tensors`` (by its ``LM``'s names, shaped as
        its parameters): gathered over tp along each one's split dim and
        put together (``tensor_parallel.unshard``), the stages' layers
        merged.  Every rank of the mesh calls it together and gets the
        same dict."""
        tp = self.ranks.tp
        specs = self.specs(tensors)
        out = {}
        for name, t in tensors.items():
            dim = _shard_dim(specs[name], self.tp_axis)
            if dim is not None and tp.size > 1:
                t = tpar.unshard(self.cfg, name,
                                 all_gather(t, tp, dim).chunk(tp.size, dim),
                                 dim)
            out[_global_name(name, self.first_layer)] = t.detach().to(
                "cpu", copy=True)
        stage = self.ranks.stage
        if stage.size > 1:
            for part in all_gather_object(out, stage):
                out.update(part)
        return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainStep(_Rank):
    """One rank's training step: ``step(params, opt, batch) -> (params,
    opt, {"loss", "grad_norm"})`` with ``params`` from ``shard`` and
    ``opt`` from ``init_opt``; ``batch`` is the global batch, the same on
    every rank.  ``loss_and_grads`` and ``apply`` are its two halves.
    ``args``: meta stand-ins (params, optimizer state, batch);
    ``param_specs``, ``opt_specs``, ``batch_specs``: placements."""
    mode: str
    n_micro: int
    lr: float
    loss_fn: object
    plan: TpuPlan | None
    args: tuple
    param_specs: dict
    opt_specs: dict
    batch_specs: dict

    def __call__(self, params, opt, batch):
        loss, grads = self.loss_and_grads(params, batch)
        gn = self.apply(params, opt, grads)
        return params, opt, {"loss": loss, "grad_norm": gn}

    # -- the gradient -------------------------------------------------------

    def loss_and_grads(self, params, batch):
        """(loss, {name: f32 gradient}) of the whole global batch: this
        rank's shards of the gradients, equal on every data rank."""
        named = dict(params.named_parameters())
        batch = _to(batch, self.device)
        if self.mode == "tapa":
            loss, grads = self._pipeline_grads(params, named, batch)
        else:
            loss, grads = self._accumulated_grads(params, named, batch)
        tpar.sum_shared_grads(self.cfg, grads, self.ranks.kv)
        data = self.ranks.data
        if data.size > 1:
            all_reduce_(list(grads.values()), data)
            for g in grads.values():
                g.div_(data.size)
            loss = all_reduce(loss, data) / data.size
        return loss, grads

    def _accumulated_grads(self, params, named, batch):
        toks = batch["tokens"]
        mb = max(toks.shape[0] // self.n_micro, 1)
        toks = toks[:mb * self.n_micro].reshape(self.n_micro, mb, -1)
        extra = batch.get("extra")
        rows = bl.batch_rows(mb, self.ranks.data)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device) for n, p in named.items()}
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for m in range(self.n_micro):
            b = {"tokens": toks[m, rows]}
            if extra:
                b["extra"] = {k: v[m * mb:(m + 1) * mb][rows]
                              for k, v in extra.items()}
            loss = self.loss_fn(params, b)
            loss.backward()
            total = total + loss.detach()
            for n, p in named.items():
                if p.grad is not None:
                    acc[n] += p.grad.float()
                    p.grad = None
        for g in acc.values():
            g.div_(self.n_micro)
        return total / self.n_micro, acc

    def _pipeline_grads(self, params, named, batch):
        toks = batch["tokens"]
        rows = bl.batch_rows(toks.shape[1], self.ranks.data)
        b = {"tokens": toks[:, rows]}
        if batch.get("extra"):
            b["extra"] = {k: v[rows] for k, v in batch["extra"].items()}
        objective, loss = self.loss_fn(params, b)
        objective.backward()
        grads = {}
        for n, p in named.items():
            grads[n] = torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) if p.grad is None \
                else p.grad.float()
            p.grad = None
        # the stage-shared parameters: each stage holds a gradient of its
        # own use of them; the whole one is their sum
        all_reduce_([g for n, g in grads.items()
                     if pp._layer_index(n) is None], self.ranks.stage)
        return loss, grads

    # -- clip and optimizer -------------------------------------------------

    def global_norm(self, grads: dict):
        """The f32 norm of the whole model's gradient, each entry counted
        once: tp-split runs summed over tp (a KV head's, held by
        ``kv_share`` ranks, divided by their count) and replicated leaves
        and runs taken once; each stage's layers summed over the stages,
        the shared parameters (equal on every stage) once."""
        specs = self.specs(grads)
        tp = self.ranks.tp.size
        sums = torch.zeros(4, dtype=torch.float32, device=self.device)
        for n, g in grads.items():
            layer = pp._layer_index(n) is not None
            dim = _shard_dim(specs[n], self.tp_axis)
            runs = [(g, tp)] if dim is None or tp == 1 else \
                tpar.local_runs(self.cfg, n, g, dim, tp)
            for piece, held in runs:
                sq = torch.sum(piece.float() ** 2)
                whole = held == tp
                sums[2 * (not layer) + whole] += sq if whole or held == 1 \
                    else sq / held
        tp_part = all_reduce(sums[[0, 2]], self.ranks.tp)
        layers = all_reduce(tp_part[0] + sums[1], self.ranks.stage)
        return torch.sqrt(layers + tp_part[1] + sums[3])

    def init_opt(self, params) -> dict:
        """The optimizer state of this rank's params, of its ZeRO-1 slice
        of each (``zero1_dim`` over the data ranks): AdamW's moments, or
        Adafactor's factored moments on the reference's stacks."""
        named = self._slices(dict(params.named_parameters()))
        if self.cfg.optimizer == "adafactor":
            return adafactor_init(named, self.stacks(named))
        return adamw_init(named)

    def stacks(self, names) -> Stacks:
        """The layers of this rank's stage that form the reference's
        stacked leaves (``_stacks``)."""
        return _stacks(self.cfg, names, self.mode)

    def held(self, tensors: dict) -> dict:
        """{name: ``optim.adafactor.Held``}: each tensor's tp-split dim
        with its entries' weights (1 / the tp ranks that hold each,
        ``tensor_parallel.local_runs``) and its ZeRO-1 slice dim."""
        specs = self.specs(tensors)
        tp, data = self.ranks.tp.size, self.ranks.data.size
        out = {}
        for n, t in tensors.items():
            dim = _shard_dim(specs[n], self.tp_axis) if tp > 1 else None
            weight = None if dim is None else torch.cat([
                torch.full((piece.shape[dim],), 1.0 / held,
                           dtype=torch.float32, device=t.device)
                for piece, held in tpar.local_runs(self.cfg, n, t, dim, tp)])
            out[n] = Held(dim, weight, zero1_dim(specs[n], tuple(t.shape),
                                                 data) if data > 1 else None)
        return out

    def _reduce(self, tensors: list, axes) -> None:
        """Sum ``tensors`` in place over the named axes of this rank."""
        for name in ("tp", "data", "stage"):
            if name in axes:
                all_reduce_(tensors, getattr(self.ranks, name))

    def _slices(self, tensors: dict) -> dict:
        """Each tensor's ZeRO-1 slice on this data rank (a view)."""
        data = self.ranks.data
        specs = self.specs(tensors)
        out = {}
        for n, t in tensors.items():
            dim = zero1_dim(specs[n], tuple(t.shape), data.size)
            if dim is None or data.size == 1:
                out[n] = t
            else:
                per = t.shape[dim] // data.size
                out[n] = t.narrow(dim, data.rank * per, per)
        return out

    @torch.no_grad()
    def apply(self, params, opt, grads):
        """Clip ``grads`` to global norm 1 and update ``params`` and
        ``opt`` in place; returns the norm before the clip.  f32 grads
        (``loss_and_grads``'s) are scaled in place: a second f32 copy of
        them would be a third of AdamW's state again."""
        gn = self.global_norm(grads)
        scale = torch.clamp(1.0 / torch.clamp(gn, min=1e-9), max=1.0)
        named = dict(params.named_parameters())
        clipped = {n: g.float().mul_(scale) for n, g in grads.items()}
        mine = self._slices(named)
        if self.cfg.optimizer == "adafactor":
            adafactor_update(mine, self._slices(clipped), opt, lr=self.lr,
                             stacks=self.stacks(mine),
                             held=self.held(named), reduce=self._reduce)
        else:
            adamw_update(mine, self._slices(clipped), opt, lr=self.lr)
        data = self.ranks.data
        if data.size > 1:
            specs = self.specs(named)
            for n, p in named.items():
                dim = zero1_dim(specs[n], tuple(p.shape), data.size)
                if dim is not None:
                    per = p.shape[dim] // data.size
                    own = p.narrow(dim, data.rank * per, per)
                    p.copy_(all_gather(own, data, dim))
        return gn


def _to(batch: dict, device) -> dict:
    out = {"tokens": batch["tokens"].to(device)}
    if batch.get("extra"):
        out["extra"] = {k: v.to(device) for k, v in batch["extra"].items()}
    return out


def _ranks(cfg: ArchConfig, mesh, stage: Axis, data: Axis,
           tp_name: str) -> pp.Ranks:
    """This rank's axes, after ``check_tp``: the attention's blocks of the
    tp axis (``attn_split``) and its KV-sharing blocks made (on every
    rank) where the heads split over fewer than tp ranks or there are
    fewer KV heads than they."""
    tp = axis(mesh, tp_name)
    tpar.check_tp(cfg, tp.size)
    t = tpar.attn_split(cfg, tp.size)
    return pp.Ranks(
        stage=stage, data=data, tp=tp,
        kv=sub_axis(mesh, tp_name, tpar.kv_share(cfg, tp.size)),
        attn=tp if t == tp.size else sub_axis(mesh, tp_name, t))


def _stacks(cfg: ArchConfig, names, mode: str) -> Stacks:
    """The layers among ``names`` that form the reference's stacked
    leaves, in its layout: (G, ...) for the baseline, (S, Gs, ...) for
    the pipeline ("tapa")."""
    return Stacks(tuple(tuple(v) for v in convert.layer_stacks(
        cfg, names).values()), pipeline=mode == "tapa")


def _state_structs(cfg: ArchConfig, p_structs, mode: str) -> dict:
    named = dict(p_structs.named_parameters())
    if cfg.optimizer == "adafactor":
        return adafactor_init(named, _stacks(cfg, named, mode))
    return adamw_init(named)


def build_baseline_train(cfg: ArchConfig, mesh, cell: ShapeCell, *,
                         n_micro: int | None = None, lr: float = 3e-4,
                         device="cuda") -> TrainStep:
    """The baseline's train step on ``mesh`` ((data, model) or (pod, data,
    model)) for this rank."""
    n_micro = n_micro or n_micro_for(cfg)
    daxes = bl.data_axes(mesh)
    ranks = _ranks(cfg, mesh, Axis(None, 1, 0), axis(mesh, daxes), "model")
    p_structs = param_structs(cfg)
    specs = bl.placements(cfg, p_structs, mesh)
    zspecs = zero1_specs(specs, _named(p_structs), data_axes=daxes,
                         data_size=ranks.data.size)
    o_structs = _state_structs(cfg, p_structs, "baseline")
    return TrainStep(
        cfg=cfg, ranks=ranks, n_stages=1, tp_axis="model",
        device=lm.resolve_device(device), mode="baseline", n_micro=n_micro,
        lr=lr, loss_fn=bl.build_loss(cfg, ranks),
        plan=None, args=(p_structs, o_structs, input_specs(cfg, cell)),
        param_specs=specs, opt_specs=_opt_spec_tree(o_structs, zspecs),
        batch_specs=_batch_specs(cfg, cell, daxes, mode="baseline"))


def build_tapa_train(cfg: ArchConfig, mesh, cell: ShapeCell, *,
                     plan: TpuPlan | None = None, n_micro: int | None = None,
                     lr: float = 3e-4, device="cuda") -> TrainStep:
    """The floorplanned pipeline's train step for this rank: ``plan`` (by
    default ``plan_cell``'s for the mesh's shape) lays the mesh's ranks
    out as (stage, data, tp) (``refined_mesh``)."""
    n_micro = n_micro or n_micro_for(cfg)
    if plan is None:
        plan = plan_cell(cfg, cell.name, tuple(mesh.mesh.shape),
                         mode="tapa")
    rmesh = refined_mesh(mesh, plan)
    ranks = _ranks(cfg, rmesh, axis(rmesh, "stage"), axis(rmesh, "data"),
                   "tp")
    p_structs = param_structs(cfg)
    specs = pp.param_specs(cfg, p_structs, tp_axis="tp",
                           tp_size=ranks.tp.size)
    zspecs = zero1_specs(specs, _named(p_structs), data_axes=("data",),
                         data_size=ranks.data.size)
    o_structs = _state_structs(cfg, p_structs, "tapa")
    bspecs = _batch_specs(cfg, cell, ("data",), mode="tapa")
    if max(cell.global_batch // n_micro, 1) % ranks.data.size:
        # small microbatches: every data rank takes all of their rows
        bspecs = {k: (None,) * len(v) if k == "tokens" else
                  {e: (None,) * len(sp) for e, sp in v.items()}
                  for k, v in bspecs.items()}
    return TrainStep(
        cfg=cfg, ranks=ranks, n_stages=plan.n_stages, tp_axis="tp",
        device=lm.resolve_device(device), mode="tapa", n_micro=n_micro,
        lr=lr, loss_fn=pp.build_train_loss(cfg, plan, ranks,
                                           n_micro=n_micro),
        plan=plan, args=(p_structs, o_structs, input_specs(
            cfg, cell, mode="tapa", n_micro=n_micro)),
        param_specs=specs, opt_specs=_opt_spec_tree(o_structs, zspecs),
        batch_specs=bspecs)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeStep(_Rank):
    """One rank's serving: ``serve(params, cache, tokens)`` with ``params``
    from ``shard`` and ``cache`` from ``init_cache``; ``tokens`` is the
    global batch's (B, S).  Returns the logits of this rank's rows over
    the whole padded vocab.  ``args``, ``param_specs``, ``cache_specs``,
    ``logits_spec``: the stand-ins and placements."""
    serve_fn: object
    kv_shard: str
    args: tuple
    param_specs: dict
    cache_specs: dict
    logits_spec: tuple

    def rows(self, n: int) -> slice:
        return bl.batch_rows(n, self.ranks.data)

    def shard(self, params, requires_grad: bool = False) -> lm.LM:
        return super().shard(params, requires_grad)

    def init_cache(self, params, batch: int, max_seq: int, extra=None):
        """This rank's cache for a global batch of ``batch`` rows, each
        attention layer's KV cache split over the attention's ranks (tp,
        or the rank's block of ``attn_split`` ranks) as
        ``baseline.kv_mode`` says (``tensor_parallel.init_cache``); with
        the stub frontend's inputs ``extra``, the memory of the X layers
        made once, whole on every rank (``tensor_parallel.memory``)."""
        rows = self.rows(batch)
        n = len(range(batch)[rows])
        if extra:
            extra = {k: v[rows].to(self.device) for k, v in extra.items()}
        tp, attn = self.ranks.tp, self.ranks.attn
        if tp.size == 1:
            return lm.init_cache(params, self.cfg, n, max_seq,
                                 device=self.device, extra=extra)
        cfg = self.cfg
        specs = lm.build_specs(cfg)
        P = len(cfg.layer_pattern)
        modes = []
        for i in range(cfg.n_layers):
            spec = specs[i % P] if cfg.layer_pattern[i % P] != "H" \
                else specs[0]
            W = max_seq if spec.window is None else min(spec.window,
                                                        max_seq)
            mode = bl.kv_mode(cfg.n_kv_heads, W, attn.size, self.kv_shard)
            if mode is None:
                raise ValueError(f"{cfg.name}: a KV cache of {W} slots and "
                                 f"{cfg.n_kv_heads} heads splits over "
                                 f"{attn.size} ranks by neither")
            modes.append(mode)
        cache = tpar.init_cache(cfg, tp, n, max_seq, kv_modes=modes,
                                device=self.device, dtype=params.embed.dtype,
                                attn_ax=attn)
        if extra:
            with torch.no_grad():
                cache["memory"] = tpar.memory(params, cfg, extra, tp, attn)
        return cache

    def __call__(self, params, cache, tokens):
        tokens = tokens[self.rows(tokens.shape[0])].to(self.device)
        return self.serve_fn(params, cache, tokens)


def build_baseline_serve(cfg: ArchConfig, mesh, cell: ShapeCell, *,
                         device="cuda", kv_shard: str = "heads") -> ServeStep:
    """The baseline's serving for this rank on ``mesh``: data-parallel
    rows, the layers split over "model" (``tensor_parallel``), each KV
    cache by heads or by its length (``kv_shard``, ``baseline.kv_mode``)."""
    daxes = bl.data_axes(mesh)
    ranks = _ranks(cfg, mesh, Axis(None, 1, 0), axis(mesh, daxes), "model")
    p_structs = param_structs(cfg)
    B = cell.global_batch
    cache_structs = lm.init_cache(p_structs, cfg, B, cell.seq_len,
                                  device="meta")
    cspecs = bl.cache_shardings(cfg, cache_structs, mesh, kv_shard=kv_shard)
    bspec = daxes if B % max(ranks.data.size, 1) == 0 else None
    return ServeStep(
        cfg=cfg, ranks=ranks, n_stages=1, tp_axis="model",
        device=lm.resolve_device(device),
        serve_fn=bl.build_serve_step(cfg, ranks), kv_shard=kv_shard,
        args=(p_structs, cache_structs, input_specs(cfg, cell)["tokens"]),
        param_specs=bl.placements(cfg, p_structs, mesh),
        cache_specs=cspecs, logits_spec=(bspec, "model"))
