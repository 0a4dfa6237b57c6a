"""Megatron-style tensor parallelism over a tp sub-group: what GSPMD does
for the JAX package when a layer's weights are sharded over the model
axis (``pipeline.param_specs`` says which dim of each).

  * attention: wq, wk, wv column-parallel (a rank holds n_heads / tp
    query heads and n_kv_heads / tp KV heads), wo row-parallel;
  * the gated MLP: w_up, w_gate column-parallel, w_down row-parallel;
  * the embedding vocab-parallel: a rank gathers the rows it holds through
    ``ops.burst_gather`` (ids of other ranks remapped to its row 0, then
    masked to zero), and the pieces are summed;
  * the LM head vocab-parallel, the cross entropy taken over the shards
    from the all-reduced max, the all-reduced sum of exponentials and the
    target logit of the rank that holds it.

A row-parallel product's partial sums meet in ``reduce_from``, whose
backward passes the gradient on; a column-parallel product's input goes
through ``copy_to``, whose backward sums the ranks' gradients.  So every
replicated parameter (the norms) gets its whole gradient on every rank,
and each shard its own.

Only the G and L layer kinds run under tp > 1.  The others (M, H, R, X),
MoE experts and whisper's encoder raise ``NotImplementedError`` naming
ROADMAP item 8c; with tp = 1 every layer runs as ``repro_torch.model.lm``
runs it.  The MoE load-balance loss is taken over the data-parallel ranks'
tokens together (``data_parallel_aux``), as GSPMD takes it over the whole
batch.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.model import lm, moe
from repro_torch.model.layers import _rounded
from .collectives import Axis, all_gather, all_reduce, copy_to, reduce_from

ITEM_8C = "ROADMAP item 8c"
#: chunks of tokens in ``chunked_ce``, as ``lm.chunked_ce``'s default
CE_CHUNKS = 8


def check_tp(cfg: ArchConfig, tp: int) -> None:
    """Raise where ``cfg`` cannot run with its layers split over ``tp``
    ranks: ``NotImplementedError`` (naming 8c) for a layer kind other than
    G and L, MoE experts or an encoder; ``ValueError`` where the heads,
    the FFN or the padded vocab do not divide."""
    if tp == 1:
        return
    other = sorted(set(cfg.layer_pattern) - set("GL"))
    if other:
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism (tp {tp}) over layer kinds "
            f"{other} waits for {ITEM_8C}; only G and L layers split")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE experts over tp {tp} wait for {ITEM_8C}")
    if cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: whisper's encoder over tp {tp} waits for "
            f"{ITEM_8C}")
    for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff), ("vocab_padded", cfg.vocab_padded)):
        if n % tp:
            raise ValueError(f"{cfg.name}: {what} {n} does not divide over "
                             f"tp {tp}")


def local_config(cfg: ArchConfig, tp: int) -> ArchConfig:
    """``cfg`` as one tp rank's layers see it: n_heads / tp, n_kv_heads /
    tp and d_ff / tp (head_dim and everything else unchanged)."""
    check_tp(cfg, tp)
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               d_ff=cfg.d_ff // tp)


def vocab_range(cfg: ArchConfig, tp: Axis) -> tuple[int, int]:
    """[lo, hi) of the padded vocab's rows this tp rank holds."""
    per = cfg.vocab_padded // tp.size
    return tp.rank * per, (tp.rank + 1) * per


# ---------------------------------------------------------------------------
# the embedding and the head
# ---------------------------------------------------------------------------

def embed(params, cfg: ArchConfig, tokens, tp: Axis):
    """``lm._embed`` over a vocab-sharded ``params.embed``: tokens (B, S)
    -> (B, S, d).  Ids outside the rank's rows read its row 0 and are
    zeroed, so the sum over the ranks is the one row that holds each id,
    exactly."""
    if tp.size == 1:
        return lm._embed(params, cfg, tokens)
    B, S = tokens.shape
    lo, hi = vocab_range(cfg, tp)
    ids = tokens.reshape(-1)
    mine = (ids >= lo) & (ids < hi)
    rows = ops.burst_gather(params.embed, torch.where(mine, ids - lo, 0))
    x = rows * mine[:, None].to(rows.dtype)
    x = reduce_from(x, tp).view(B, S, cfg.d_model)
    if cfg.embed_scale:
        x = x * _rounded(math.sqrt(cfg.d_model), x.dtype)
    return x


def head_logits(params, cfg: ArchConfig, x, tp: Axis):
    """``lm.lm_head`` over the rank's vocab columns: final norm, the tied
    (``embed`` transposed) or untied head's shard, the final softcap, and
    the padded columns past ``cfg.vocab`` set to -1e30.  (..., d) ->
    (..., vocab_padded / tp) in x's dtype."""
    h = copy_to(params.ln_f(x), tp)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = h @ w.to(h.dtype)
    if cfg.final_logit_softcap:
        c = _rounded(cfg.final_logit_softcap, logits.dtype)
        logits = torch.tanh(logits / c) * c
    lo, hi = vocab_range(cfg, tp)
    if hi > cfg.vocab:
        cols = torch.arange(lo, hi, device=logits.device)
        logits = logits.masked_fill(cols >= cfg.vocab, -1e30)
    return logits


def logits(params, cfg: ArchConfig, x, tp: Axis):
    """The whole padded vocab's logits of x (..., d), gathered over tp."""
    if tp.size == 1:
        return lm.lm_head(params, cfg, x)
    return all_gather(head_logits(params, cfg, x, tp), tp, -1)


def _chunk_ce(params, cfg: ArchConfig, xc, tc, tp: Axis):
    """(chunk,) cross entropies of f32 hidden states xc (chunk, d) against
    targets tc: logz - the target's logit.  With the head split over tp,
    logz = log(sum over ranks of sum exp(l - m)) + m with m the
    all-reduced max (no gradient: it cancels), and the target logit comes
    from the rank that holds the target, summed over the ranks."""
    if tp.size == 1:
        lg = lm.lm_head(params, cfg, xc[None])[0]
        return torch.logsumexp(lg, dim=-1) - \
            torch.gather(lg, -1, tc[:, None])[:, 0]
    lg = head_logits(params, cfg, xc, tp)
    m = all_reduce(lg.detach().amax(-1), tp, torch.distributed.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(lg - m[:, None]).sum(-1), tp)
    lo, hi = vocab_range(cfg, tp)
    mine = (tc >= lo) & (tc < hi)
    ll = torch.gather(lg, -1, torch.where(mine, tc - lo, 0)[:, None])[:, 0]
    return torch.log(sumexp) + m - reduce_from(ll * mine.float(), tp)


def chunked_ce(params, cfg: ArchConfig, x, targets, tp: Axis):
    """``lm.chunked_ce``: the mean cross entropy of hidden states x (B, S,
    d), the (tokens, vocab) f32 logits made one chunk of tokens at a time,
    here with the head split over tp (``_chunk_ce``).  Each chunk is
    recomputed in the backward: what its product saves for the backward
    is the head widened to f32 (0.8 GB for granite-8b's tied embedding),
    and a pipeline stage holds every microbatch's graph at once."""
    B, S, d = x.shape
    T = B * S
    chunk = max(-(-T // CE_CHUNKS), 1)
    pad = chunk * CE_CHUNKS - T
    xf = torch.nn.functional.pad(x.reshape(T, d), (0, 0, 0, pad))
    tf = torch.nn.functional.pad(targets.reshape(T).long(), (0, pad))
    mf = torch.nn.functional.pad(
        torch.ones(T, dtype=torch.float32, device=x.device), (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(CE_CHUNKS):
        sl = slice(c * chunk, (c + 1) * chunk)
        ce = checkpoint.checkpoint(_chunk_ce, params, cfg, xf[sl].float(),
                                   tf[sl], tp, use_reentrant=False)
        total = total + (ce * mf[sl]).sum()
    return total / torch.clamp(mf.sum(), min=1.0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def data_parallel_aux(data: Axis):
    """The MoE load-balance loss of ``moe.aux_loss`` over the tokens of
    every data-parallel rank together: the expert counts and the mean
    probability all-reduced.  The mean enters as the local mean shifted by
    a constant to the global one, so that this rank's gradient is the
    whole batch's loss's gradient through its own tokens times the data
    size: averaged over the data ranks, as the step averages gradients,
    that is the whole batch's gradient.  None on one data rank (the
    layer's own ``moe.aux_loss``)."""
    if data.size == 1:
        return None

    def aux(probs, top_i, E, dtype):
        T = top_i.shape[0]
        counts = all_reduce(moe.expert_counts(top_i, E), data)
        Tg = T * data.size
        frac = (counts.float() / Tg).to(dtype).float()
        local = probs.mean(0)
        whole = all_reduce(probs.detach().sum(0), data) / Tg
        return E * torch.sum(frac * (local + (whole - local).detach()))
    return aux


def block(layer, x, cfg: ArchConfig, local: ArchConfig, spec, rope,
          tp: Axis, *, cache=None, pos: int = 0, aux_fn=None):
    """A G or L layer (``lm.Block``) with its attention and MLP split over
    tp: -> (x, aux)."""
    a = layer.attn(copy_to(layer.ln_attn(x), tp), local, spec, rope,
                   cache=cache, pos=pos)
    a = reduce_from(a, tp)
    if cfg.post_norms:
        a = layer.ln_attn_post(a)
    x = x + a
    h = layer.ln_mlp(x)
    if cfg.n_experts:                      # tp == 1 (check_tp)
        f, aux = layer.moe(h, cfg, aux_fn=aux_fn)
        if cfg.dense_residual:
            f = f + layer.mlp(h, cfg)
    else:
        f, aux = reduce_from(layer.mlp(copy_to(h, tp), local), tp), 0.0
    if cfg.post_norms:
        f = layer.ln_mlp_post(f)
    return x + f, aux


class Layers(lm._Layers):
    """``lm._Layers`` over one rank's params (a stage's layers, each split
    over tp): the G and L layers through ``block``; the other kinds as the
    model runs them (tp 1 only, ``check_tp``)."""

    def __init__(self, params, cfg: ArchConfig, positions, *, x0,
                 memory=None, tp: Axis, data: Axis):
        super().__init__(params, cfg, positions, x0=x0, memory=memory)
        self.tp, self.local = tp, local_config(cfg, tp.size)
        self.aux_fn = data_parallel_aux(data)

    def __call__(self, i: int, x, *, cache=None, pos: int = 0):
        cfg = self.cfg
        j = i % len(cfg.layer_pattern)
        if cfg.layer_pattern[j] in "GL":
            spec = self.specs[j]
            return block(self.params.layers[i], x, cfg, self.local, spec,
                         self.rope(spec), self.tp, cache=cache, pos=pos,
                         aux_fn=self.aux_fn)
        return super().__call__(i, x, cache=cache, pos=pos)


def apply_layers(layers: Layers, n_layers: int, x):
    """Every layer of ``layers``, group by group (``len(layer_pattern)``
    layers), each group recomputed in the backward as in
    ``lm.forward(remat=True)``.  -> (x, aux summed layer after layer, f32)."""
    P = len(layers.cfg.layer_pattern)

    def group(first, x, aux):
        for i in range(first, min(first + P, n_layers)):
            x, a = layers(i, x)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for first in range(0, n_layers, P):
        x, aux = checkpoint.checkpoint(group, first, x, aux,
                                       use_reentrant=False)
    return x, aux
