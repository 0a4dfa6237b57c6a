"""Megatron-style tensor parallelism over a tp sub-group: what GSPMD does
for the JAX package when a layer's weights are sharded over the model
axis (``pipeline.param_specs`` says which dim of each, ``cut`` how).

  * attention (self-, an X layer's cross-attention, whisper's encoder's):
    wq, wk, wv column-parallel, wo row-parallel, over t ranks, the largest
    divisor of tp its heads split over (``attn_split``; tp where they
    divide).  A rank holds n_heads / t query heads and the n_kv_heads / t
    KV heads they read; with fewer KV heads than t it holds the one KV
    head its query heads read, the same columns of wk and wv as the t /
    n_kv_heads ranks beside it (``kv_share``), whose gradients the step
    sums over those ranks (``sum_shared_grads``).  With t < tp each block
    of t consecutive ranks holds every head once and the blocks are
    copies: the attention's ``copy_to`` and ``reduce_from`` run over the
    rank's block (``collectives.sub_axis``), so every copy's gradient is
    whole, and the step counts a copy once.  A cross-attention's memory
    is whole on every rank and enters its K/V products through
    ``copy_to``; its gate is whole;
  * the gated MLP: w_up, w_gate column-parallel, w_down row-parallel;
  * MoE experts (``moe_layer``) by ``moe_placement``: whole experts a
    rank where E divides tp, else every expert's FFN dim; the router
    whole on every rank;
  * mamba2 (M, and the mamba2 of H): by head.  The fused ``w_in`` [z, x,
    B, C, dt] is cut segment by segment, z, x and dt by head, B and C
    whole on every rank, as are their conv taps; ``conv_w`` by x's
    channels, A_log, dt_bias and D by head; the gated RMSNorm over the
    whole d_in takes its sum of squares over the ranks; w_out
    row-parallel.  B and C are made from the layer's input on every rank
    and enter the scan through ``copy_to``, so their weights' gradients
    are whole on every rank;
  * zamba2's shared block (H): w_shared_in column-parallel (its output
    gathered, ``gather_from``), the shared attention and MLP as the G
    layers', w_shared_out row-parallel (its input the rank's slice,
    ``scatter_to``);
  * rwkv6 (R): the time-mix by head (r, k, v, g column-parallel, the
    decay's w_B, w_base and u, and ``ln_x``'s weight by head; ``ln_x``
    over the whole d takes its sum of squares over the ranks; wo
    row-parallel); the decay's low-rank w_A and the token-shift lerps mu
    whole on every rank; the channel-mix's wk column- and wv
    row-parallel, its gate wr column-parallel and gathered.  Each mix
    enters its by-head products through one ``copy_to`` of its input h
    (the lerps with h's shift taken on every rank), and the lerps' mu
    through another, so h's gradient is one all-reduce a mix and mu's a
    d-sized one;
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

Serving keeps a KV cache split by heads or, where the heads do not divide
(or by choice), by its length (``context_attention``: a rank holds a slice
of every head's keys, the ranks' partial outputs merge by their
log-sum-exp).

Whisper's encoder runs as G layers over tp (``encode``).  With tp = 1
every layer runs as ``repro_torch.model.lm`` runs it.  ``check_tp``
raises ``ValueError`` where an FFN, the padded vocab or the SSM heads do
not divide.  The MoE load-balance loss is taken
over the data-parallel ranks' tokens together (``data_parallel_aux``), as
GSPMD takes it over the whole batch.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.model import lm, moe
from repro_torch.model.layers import (AttnSpec, _rounded, apply_rope,
                                     rope_dim, rope_tables, sigmoid, silu)
from repro_torch.model.mamba2 import _causal_conv
from repro_torch.model.rwkv6 import _mix, _token_shift
from .collectives import (Axis, all_gather, all_reduce, all_reduce_,
                          copy_to, gather_from, reduce_from, scatter_to,
                          sum_over)

#: chunks of tokens in ``chunked_ce``, as ``lm.chunked_ce``'s default
CE_CHUNKS = 8
#: the leaves of an attention's heads
_ATTN_LEAVES = ("wq", "wk", "wv", "wo")


def check_tp(cfg: ArchConfig, tp: int) -> None:
    """Raise ``ValueError`` where ``cfg`` cannot run with its layers split
    over ``tp`` ranks: the dense FFN, the padded vocab, the experts' FFN
    (where they split by it, ``moe_placement``), or the mamba2 or rwkv6
    heads do not divide.  Attention heads always split, over
    ``attn_split``'s divisor of tp."""
    if tp == 1:
        return
    kinds = set(cfg.layer_pattern)
    sizes = [("d_ff", cfg.d_ff), ("vocab_padded", cfg.vocab_padded)]
    if cfg.n_experts and moe_placement(cfg.n_experts, tp) == "ffn":
        sizes.append(("moe_d_ff", cfg.moe_d_ff))
    if kinds & set("MH"):
        sizes.append(("mamba2 heads", _ssm_heads(cfg)))
    if "R" in kinds:
        sizes.append(("rwkv6 heads", cfg.d_model // cfg.ssm_head_dim))
    for what, n in sizes:
        if n % tp:
            raise ValueError(f"{cfg.name}: {what} {n} does not divide over "
                             f"tp {tp}")


def _ssm_heads(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim


def attn_split(cfg: ArchConfig, tp: int) -> int:
    """t, the tp ranks an attention's heads split over: the largest
    divisor of tp that the query heads split into and whose KV heads
    split into it or are shared (``kv_share``).  The other tp / t ranks
    hold copies: blocks of t consecutive ranks (``collectives.sub_axis``)
    each hold every head once.  tp where the heads split over all of it;
    1 (the whole attention on every rank) at worst."""
    for t in range(tp, 0, -1):
        if tp % t == 0 and cfg.n_heads % t == 0 and (
                cfg.n_kv_heads % t == 0 or t % cfg.n_kv_heads == 0):
            return t
    return 1


def kv_share(cfg: ArchConfig, tp: int) -> int:
    """Ranks of an attention's block (``attn_split``'s t) that hold one KV
    head: t / n_kv_heads where there are fewer KV heads than t, else 1."""
    t = attn_split(cfg, tp)
    return t // cfg.n_kv_heads if cfg.n_kv_heads < t else 1


def moe_placement(n_experts: int, tp: int) -> str:
    """The reference's rule (``repro/distributed/pipeline.py:78-84``):
    "expert" (each tp rank E / tp whole experts) where the experts split
    over tp, else "ffn" (every expert's FFN dim cut over tp)."""
    return "expert" if n_experts % max(tp, 1) == 0 else "ffn"


def local_config(cfg: ArchConfig, tp: int) -> ArchConfig:
    """``cfg`` as one tp rank's attention and MLP see it: n_heads / t,
    n_kv_heads / t (1 with fewer KV heads than t), t = ``attn_split``,
    and d_ff / tp (head_dim and everything else unchanged)."""
    check_tp(cfg, tp)
    if tp == 1:
        return cfg
    t = attn_split(cfg, tp)
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // t,
                               n_kv_heads=max(cfg.n_kv_heads // t, 1),
                               d_ff=cfg.d_ff // tp)


# ---------------------------------------------------------------------------
# how a parameter is cut over tp
# ---------------------------------------------------------------------------

def segments(cfg: ArchConfig, name: str, size: int) -> tuple:
    """The whole model's ``size`` entries of parameter ``name`` along its
    tp dim as (length, split) runs: a split run is cut into equal pieces
    over the ranks, a whole one is held by every rank.  mamba2's fused
    ``w_in`` and its ``conv_w`` have whole runs (B and C); every other
    parameter is one split run."""
    leaf = name.rsplit(".", 1)[-1]
    if ".mamba." in f".{name}" and leaf in ("w_in", "conv_w"):
        d_in = cfg.ssm_expand * cfg.d_model
        bc = (2 * cfg.ssm_state, False)
        if leaf == "w_in":
            return ((d_in, True), (d_in, True), bc, (_ssm_heads(cfg), True))
        return ((d_in, True), bc)
    return ((size, True),)


def _attn_leaf(name: str) -> str | None:
    """"q" for an attention's wq or wo, "kv" for its wk or wv, else
    None."""
    parts = name.rsplit(".", 2)
    if len(parts) < 2 or parts[-2] not in ("attn", "xattn") or \
            parts[-1] not in _ATTN_LEAVES:
        return None
    return "kv" if parts[-1] in ("wk", "wv") else "q"


def _cut(cfg: ArchConfig, name: str, tp: int):
    """(the pieces a split run of ``name`` is cut into, the piece tp rank
    r holds).  An attention's query leaves: t pieces (``attn_split``),
    rank r the (r mod t)-th, so that each block of t consecutive ranks
    holds every head; its KV leaves: t / ``kv_share`` pieces, shared by
    consecutive ranks of the block.  Every other leaf: tp pieces, rank r
    the r-th."""
    kind = _attn_leaf(name)
    if kind is None:
        return tp, lambda r: r
    t = attn_split(cfg, tp)
    step = kv_share(cfg, tp) if kind == "kv" else 1
    return t // step, lambda r: (r % t) // step


def share(cfg: ArchConfig, name: str, tp: int) -> int:
    """tp ranks that hold each piece of ``name``'s split runs: the copies
    of an attention's heads (tp / t) times its KV heads' ``kv_share``,
    else 1."""
    return tp // _cut(cfg, name, tp)[0]


def shard(cfg: ArchConfig, name: str, t, dim: int, tp: Axis):
    """The whole parameter ``t``'s shard on this tp rank, cut along
    ``dim``."""
    n, piece = _cut(cfg, name, tp.size)
    pieces, off = [], 0
    for size, split in segments(cfg, name, t.shape[dim]):
        run = t.narrow(dim, off, size)
        pieces.append(run.chunk(n, dim)[piece(tp.rank)] if split else run)
        off += size
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


def local_runs(cfg: ArchConfig, name: str, t, dim: int, tp: int):
    """[(piece of the shard ``t`` along ``dim``, tp ranks that hold it)]:
    its split runs (``share`` ranks each) and its whole runs (all tp)."""
    n = _cut(cfg, name, tp)[0]
    out, off = [], 0
    for length, split in segments(cfg, name, t.shape[dim] * n):
        local = length // n if split else length
        out.append((t.narrow(dim, off, local), tp // n if split else tp))
        off += local
    return out


def unshard(cfg: ArchConfig, name: str, parts: list, dim: int):
    """The whole parameter from every tp rank's shard ``parts``, in rank
    order (the inverse of ``shard``)."""
    tp = len(parts)
    n, piece = _cut(cfg, name, tp)
    holders = [min(r for r in range(tp) if piece(r) == j) for j in range(n)]
    runs = [local_runs(cfg, name, p, dim, tp) for p in parts]
    whole = []
    for i, (_, held) in enumerate(runs[0]):
        whole += [runs[r][i][0] for r in holders] if held < tp else \
            [runs[0][i][0]]
    return whole[0] if len(whole) == 1 else torch.cat(whole, dim)


def sum_shared_grads(cfg: ArchConfig, grads: dict, kv: Axis) -> None:
    """Sum over the ranks that share a KV head (``kv``, ``kv_share`` of
    them) each one's gradient of that head's wk and wv columns, in place:
    each rank's is the gradient through its own query heads."""
    if kv.size > 1:
        all_reduce_([g for n, g in grads.items()
                     if _attn_leaf(n) == "kv"], kv)


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


def _rms(x, w, tp: Axis, width: int, eps: float = 1e-6):
    """``layers.rmsnorm`` over a row split across tp (``width`` entries in
    all): the sum of squares summed over the ranks, then this rank's
    entries scaled by their weights."""
    xf = x.float()
    ss = sum_over(torch.sum(xf * xf, dim=-1, keepdim=True), tp)
    return ((xf * torch.rsqrt(ss / width + eps)) * w).to(x.dtype)


def attention(attn, x, cfg: ArchConfig, local: ArchConfig, spec, rope,
              ax: Axis, *, cache=None, pos: int = 0, memory=None):
    """``layers.Attention`` over this rank's heads of its block of
    ``attn_split`` ranks (``ax``): its partial output (B, S, d), summed
    over ``ax`` by the caller.  A cache split by its length (one with a
    "context" entry) takes ``context_attention``.  With ``memory``, a
    cross-attention: K and V from the memory (whole on every rank),
    which enters the rank's K/V products through ``copy_to`` so that its
    gradient is whole."""
    if memory is not None:
        return attn(copy_to(x, ax), local, spec, None,
                    kv_from=copy_to(memory, ax))
    if cache is not None and "context" in cache:
        return context_attention(attn, x, cfg, local, spec, rope, ax, cache,
                                 pos)
    return attn(copy_to(x, ax), local, spec, rope, cache=cache, pos=pos)


def _ring_tokens(lo: int, n: int, S: int, W: int, device):
    """The prefill's token at each of the ring slots [lo, lo + n) of a
    cache of W slots after S tokens (token t at slot t % W, the last W
    kept), and whether the slot holds one."""
    j = torch.arange(lo, lo + n, device=device)
    if S >= W:
        return (S - W) + torch.remainder(j - (S - W), W), j >= 0
    return j.clamp(max=max(S - 1, 0)), j < S


def context_attention(attn, x, cfg: ArchConfig, local: ArchConfig, spec,
                      rope, tp: Axis, cache, pos: int):
    """Attention with a context-parallel cache: this rank holds the slots
    [lo, lo + W / tp) of every KV head's W (``cache["context"]`` is (lo,
    W)); a windowed layer's ring buffer is split alike, W its window.

    Prefill (from position 0): this rank's query heads attend to the new
    tokens as in ``attention``; the new keys and values of every head are
    gathered over tp and each rank writes the ring slots it holds.  Decode:
    the new token's keys and values go to the rank that holds its slot;
    every rank runs ``decode_attention`` for all query heads (gathered)
    over its slots, with ``kv_len`` clipped to them, and gets each row's
    log-sum-exp; the ranks' (o, lse) are gathered and merged by the
    weights exp(lse - max) (a slice with no valid key has lse = -inf and
    weighs 0), and this rank keeps its query heads."""
    B, S, _ = x.shape
    Hl, D = local.n_heads, cfg.head_dim
    xt = copy_to(x, tp)
    q = (xt @ attn.wq).view(B, S, Hl, D)
    k = (xt @ attn.wk).view(B, S, local.n_kv_heads, D)
    v = (xt @ attn.wv).view(B, S, local.n_kv_heads, D)
    cos, sin = rope
    q = apply_rope(q, cos, sin, cfg.rope_style)
    k = apply_rope(k, cos, sin, cfg.rope_style)
    step = kv_share(cfg, tp.size)
    k_all = all_gather(k, tp, 2)[:, :, ::step]
    v_all = all_gather(v, tp, 2)[:, :, ::step]
    ck, cv = cache["k"], cache["v"]
    lo, W = cache["context"]
    n = ck.shape[1]
    if S > 1:
        out = ops.attention(q, k, v, causal=spec.causal, window=spec.window,
                            softcap=spec.softcap, scale=cfg.query_scale)
        tok, held = _ring_tokens(lo, n, S, W, ck.device)
        keep = held[None, :, None, None].to(ck.dtype)
        ck.copy_(k_all[:, tok].to(ck.dtype) * keep)
        cv.copy_(v_all[:, tok].to(cv.dtype) * keep)
        return out.reshape(B, S, Hl * D) @ attn.wo
    slot = min(pos if spec.window is None else pos % W, W - 1)
    if lo <= slot < lo + n:
        ck[:, slot - lo] = k_all[:, 0]
        cv[:, slot - lo] = v_all[:, 0]
    valid = pos + 1 if spec.window is None else min(pos + 1, W)
    o, lse = ops.attention(all_gather(q, tp, 2), ck, cv, causal=False,
                           softcap=spec.softcap, scale=cfg.query_scale,
                           kv_len=min(max(valid - lo, 0), n),
                           return_lse=True)
    os_ = all_gather(o[None].float(), tp, 0)          # (tp, B, 1, Hq, D)
    lses = all_gather(lse[None], tp, 0)               # (tp, B, Hq)
    top = lses.amax(0)
    w = torch.where(torch.isfinite(lses), torch.exp(lses - top), 0.0)
    den = w.sum(0)
    merged = (w[:, :, None, :, None] * os_).sum(0) / \
        torch.where(den > 0, den, 1.0)[:, None, :, None]
    mine = merged[:, :, tp.rank * Hl:(tp.rank + 1) * Hl].to(q.dtype)
    return mine.reshape(B, S, Hl * D) @ attn.wo


def moe_layer(m, x, cfg: ArchConfig, tp: Axis, placement: str, *,
              aux_fn=None):
    """``moe.MoE`` with its experts over tp: -> (y, aux).  Activations
    are replicated over tp, so every rank routes the same tokens (the
    router whole on every rank) and gathers all T k sorted rows.
    "expert": the rank runs its E / tp experts, ids shifted by its first
    (the rows of other experts come out zero and cost their zero writes
    only, ``moe_gmm``); "ffn": every expert's FFN dim is cut over tp and
    every rank runs every row.  The weighted combine's f32 partial sums
    meet in one ``reduce_from``, rounded once to x's dtype.  The rows and
    the combine weights enter through ``copy_to``, so x's and the
    router's gradients are whole: the sum of the ranks' parts.  The aux
    loss is taken once, the same on every rank (``aux_fn``, over the data
    ranks' tokens).  No host sync: the shapes are static, and the
    shape-only FLOPs of an expert-parallel product count the expected
    T k E_local / E rows."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    probs, top_p, top_i = moe.route(m.router, cfg, xf)
    first, rows = 0, None
    if placement == "expert" and tp.size > 1:
        n_local = m.w_up.shape[0]
        first = tp.rank * n_local
        rows = top_i.numel() * n_local // cfg.n_experts
    y = moe.experts(m, cfg, copy_to(xf, tp), copy_to(top_p, tp), top_i,
                    first=first, rows=rows)
    y = reduce_from(y, tp).to(x.dtype)
    aux = (aux_fn or moe.aux_loss)(probs, top_i, cfg.n_experts, x.dtype)
    return y.view(B, S, d), aux


def _ffn(layer, x, cfg: ArchConfig, local: ArchConfig, tp: Axis,
         placement: str, aux_fn):
    """A block's FFN sublayer over tp (``lm.Block.feed_forward``): the MLP
    column- then row-parallel, or the MoE (``moe_layer``) plus arctic's
    dense residual MLP split as the MLP is.  -> (x, aux)."""
    h = layer.ln_mlp(x)
    if cfg.n_experts:
        if tp.size == 1:
            f, aux = layer.moe(h, cfg, aux_fn=aux_fn)
        else:
            f, aux = moe_layer(layer.moe, h, cfg, tp, placement,
                               aux_fn=aux_fn)
        if cfg.dense_residual:
            f = f + reduce_from(layer.mlp(copy_to(h, tp), local), tp)
    else:
        f, aux = reduce_from(layer.mlp(copy_to(h, tp), local), tp), 0.0
    if cfg.post_norms:
        f = layer.ln_mlp_post(f)
    return x + f, aux


def block(layer, x, cfg: ArchConfig, local: ArchConfig, spec, rope,
          tp: Axis, *, attn_ax: Axis | None = None, cache=None, pos: int = 0,
          aux_fn=None, placement: str = "expert", memory=None):
    """A G, L or X layer (``lm.Block``, ``lm.CrossBlock``), or an encoder
    block, with its attention over ``attn_ax`` (the rank's block of
    ``attn_split`` ranks; tp by default) and its FFN over tp: -> (x,
    aux).  An X layer's gated cross-attention over ``memory`` splits by
    heads as the attention does; its gate is whole on every rank."""
    ax = tp if attn_ax is None else attn_ax
    a = attention(layer.attn, layer.ln_attn(x), cfg, local, spec, rope, ax,
                  cache=cache, pos=pos)
    a = reduce_from(a, ax)
    if cfg.post_norms:
        a = layer.ln_attn_post(a)
    x = x + a
    if memory is not None:
        xa = reduce_from(attention(layer.xattn, layer.ln_xattn(x), cfg,
                                   local, spec, None, ax, memory=memory), ax)
        x = x + torch.tanh(layer.xattn_gate).to(x.dtype) * xa
    return _ffn(layer, x, cfg, local, tp, placement, aux_fn)


def mamba(m, x, cfg: ArchConfig, tp: Axis, cache=None):
    """``mamba2.Mamba2`` over this rank's heads: its partial output (B,
    S, d), summed over tp by the caller.  cache: this rank's conv state
    (its x channels, then B and C) and ssd state (its heads), replaced."""
    B, S, _ = x.shape
    d_in = cfg.ssm_expand * cfg.d_model
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    dl, Hl = d_in // tp.size, _ssm_heads(cfg) // tp.size
    xt = copy_to(x, tp)
    z, xin = torch.split(xt @ m.w_in[:, :2 * dl], [dl, dl], dim=-1)
    dt = xt @ m.w_in[:, 2 * dl + 2 * N:]
    bc = x @ m.w_in[:, 2 * dl:2 * dl + 2 * N]
    state = None if cache is None else cache["conv"]
    xc, new_x = _causal_conv(xin, m.conv_w[:, :dl],
                             None if state is None else state[..., :dl])
    bcc, new_bc = _causal_conv(bc, m.conv_w[:, dl:],
                               None if state is None else state[..., dl:])
    xin = silu(xc)
    Bc, Cc = torch.split(copy_to(silu(bcc), tp), [N, N], dim=-1)
    dtp = F.softplus(dt.float() + m.dt_bias)
    A = -torch.exp(m.A_log)
    xh = xin.reshape(B, S, Hl, P)
    y, new_ssd = ops.mamba2_scan(xh, dtp, A, Bc, Cc,
                                 None if cache is None else cache["ssd"])
    y = y + xh * m.D[None, None, :, None].to(y.dtype)
    y = _rms(y.reshape(B, S, dl), m.norm.w, tp, d_in) * silu(z)
    if cache is not None:
        cache["conv"] = torch.cat([new_x, new_bc], dim=-1)
        cache["ssd"] = new_ssd
    return y @ m.w_out


def hybrid(layer, x, cfg: ArchConfig, local: ArchConfig, spec, rope,
           tp: Axis, *, attn_ax: Axis, shared, x0, cache=None, pos: int = 0):
    """``lm.HybridBlock`` over tp: the mamba2 by head, then the shared
    block, its input projection column-parallel and gathered, its
    attention (over ``attn_ax``) and MLP as a G layer's, its output
    projection row-parallel on this rank's slice."""
    x = x + reduce_from(mamba(layer.mamba, layer.ln(x), cfg, tp,
                              None if cache is None else cache["mamba"]), tp)
    hin = layer.ln_shared_in(torch.cat([x, x0], dim=-1))
    h = gather_from(copy_to(hin, tp) @ layer.w_shared_in, tp, -1)
    a = reduce_from(attention(shared.attn, h, cfg, local, spec, rope,
                              attn_ax,
                              cache=None if cache is None else cache["attn"],
                              pos=pos), attn_ax)
    a = a + reduce_from(shared.mlp(copy_to(shared.ln_mlp(a), tp), local),
                        tp)
    return x + reduce_from(scatter_to(a, tp, -1) @ layer.w_shared_out, tp)


def rwkv(layer, x, cfg: ArchConfig, tp: Axis, cache=None):
    """``lm.RWKVBlock`` over tp: the time-mix by head, the channel-mix
    column- then row-parallel (see the module's docstring)."""
    B, S, d = x.shape
    zeros = x.new_zeros((B, 1, d))
    tm_shift, cm_shift, wkv = (zeros, zeros, None) if cache is None \
        else (cache["tm_shift"], cache["cm_shift"], cache["wkv"])
    tm, cm = layer.rwkv.time_mix, layer.rwkv.chan_mix
    D = cfg.ssm_head_dim
    Hl = d // D // tp.size

    h = layer.ln_tm(x)
    # the decay's low rank from h itself: w_A is whole, its output meets
    # the by-head w_B through copy_to
    lora = torch.tanh(_mix(h, _token_shift(h, tm_shift), tm.mu[4]).float()
                      @ tm.w_A.float())
    w_raw = tm.w_base[None, None] + copy_to(lora, tp) @ tm.w_B.float()
    # r, k, v and g mix one copy of h, and of its shift, with mu's rows
    # whose gradients are summed over the ranks (copy_to): one all-reduce
    # of h's gradient for the four by-head products
    ht = copy_to(h, tp)
    hts = _token_shift(ht, tm_shift)
    mu = copy_to(tm.mu[:4], tp)
    r, k, v = ((_mix(ht, hts, mu[i]) @ w).view(B, S, Hl, D)
               for i, w in enumerate((tm.wr, tm.wk, tm.wv)))
    g = silu(_mix(ht, hts, mu[3]) @ tm.wg)
    w = torch.exp(-torch.exp(w_raw)).view(B, S, Hl, D)
    y, wkv = ops.rwkv6_scan(r, k, v, w.to(r.dtype), tm.u, wkv)
    y = _rms(y.reshape(B, S, Hl * D), tm.ln_x.w, tp, d) * g
    x = x + reduce_from(y @ tm.wo, tp)
    tm_shift = h[:, -1:]

    h = layer.ln_cm(x)
    ht = copy_to(h, tp)
    hts = _token_shift(ht, cm_shift)
    mu = copy_to(cm.mu, tp)
    kk = torch.square(F.relu(_mix(ht, hts, mu[0]) @ cm.wk))
    rr = sigmoid(gather_from(_mix(ht, hts, mu[1]) @ cm.wr, tp, -1))
    x = x + rr * reduce_from(kk @ cm.wv, tp)
    if cache is not None:
        cache.update(tm_shift=tm_shift, cm_shift=h[:, -1:], wkv=wkv)
    return x


def encode(params, cfg: ArchConfig, frames, tp: Axis, attn_ax: Axis):
    """``lm._encode`` over tp: whisper's non-causal encoder blocks as G
    layers (``block``), then ``ln_enc``; the result whole on every
    rank."""
    x = lm._frontend(params, frames)
    spec = AttnSpec(causal=False, rope_theta=cfg.rope_theta)
    rope = rope_tables(torch.arange(x.shape[1], device=x.device),
                       rope_dim(cfg), spec.rope_theta)
    local = local_config(cfg, tp.size)
    for b in params.encoder:
        x, _ = block(b, x, cfg, local, spec, rope, tp, attn_ax=attn_ax)
    return params.ln_enc(x)


def memory(params, cfg: ArchConfig, extra, tp: Axis, attn_ax: Axis):
    """``lm._memory`` over tp: the encoder's output (``encode``) or the
    projected vision rows, whole on every rank, or None."""
    if tp.size > 1 and cfg.n_enc_layers and extra is not None and \
            "frames" in extra:
        return encode(params, cfg, extra["frames"], tp, attn_ax)
    return lm._memory(params, cfg, extra)


class Layers(lm._Layers):
    """``lm._Layers`` over one rank's params (a stage's layers, each split
    over tp): G, L and X layers through ``block`` (their attention over
    ``attn``, the rank's block of ``attn_split`` ranks, tp by default; the
    MoE's experts placed by ``moe_placement``), M through ``mamba``, H
    through ``hybrid``,
    R through ``rwkv``.  With tp = 1 every kind runs as the model runs
    it."""

    def __init__(self, params, cfg: ArchConfig, positions, *, x0,
                 memory=None, tp: Axis, data: Axis, attn: Axis | None = None):
        super().__init__(params, cfg, positions, x0=x0, memory=memory)
        self.tp, self.local = tp, local_config(cfg, tp.size)
        self.attn = tp if attn is None else attn
        self.placement = moe_placement(cfg.n_experts or 1, tp.size)
        self.aux_fn = data_parallel_aux(data)

    def __call__(self, i: int, x, *, cache=None, pos: int = 0):
        cfg, tp = self.cfg, self.tp
        j = i % len(cfg.layer_pattern)
        kind, spec, layer = cfg.layer_pattern[j], self.specs[j], \
            self.params.layers[i]
        if kind in "GL" or (kind == "X" and tp.size > 1):
            return block(layer, x, cfg, self.local, spec, self.rope(spec),
                         tp, attn_ax=self.attn, cache=cache, pos=pos,
                         aux_fn=self.aux_fn, placement=self.placement,
                         memory=self.memory if kind == "X" else None)
        if tp.size == 1:
            return super().__call__(i, x, cache=cache, pos=pos)
        if kind == "M":
            return x + reduce_from(mamba(layer.mamba, layer.ln(x), cfg, tp,
                                         cache), tp), 0.0
        if kind == "H":
            return hybrid(layer, x, cfg, self.local, spec, self.rope(spec),
                          tp, attn_ax=self.attn,
                          shared=self.params.shared[self.shared_idx[j]],
                          x0=self.x0, cache=cache, pos=pos), 0.0
        return rwkv(layer, x, cfg, tp, cache), 0.0


def init_cache(cfg: ArchConfig, tp: Axis, batch: int, max_seq: int,
               *, kv_modes, device, dtype, attn_ax: Axis | None = None):
    """One tp rank's serving cache (``lm.init_cache``'s structure): each
    attention layer's k and v over its block of ``attn_split`` ranks
    (``attn_ax``, tp by default) by ``kv_modes[i]`` ("heads": its KV
    heads, W slots; "context": every KV head, its W / t slots, with
    "context" (lo, W)); mamba2's conv state (its x channels, then B and C)
    and ssd state (its heads); rwkv6's token shifts whole and wkv state
    (its heads).  The memory of the X layers is the caller's."""
    specs = lm.build_specs(cfg)
    local = local_config(cfg, tp.size)
    ax = tp if attn_ax is None else attn_ax
    D, P, N = cfg.head_dim, cfg.ssm_head_dim, cfg.ssm_state
    pattern = cfg.layer_pattern

    def attn(i, spec):
        W = max_seq if spec.window is None else min(spec.window, max_seq)
        if kv_modes[i] == "heads":
            shape, extra = (batch, W, local.n_kv_heads, D), {}
        else:
            n = W // ax.size
            shape, extra = (batch, n, cfg.n_kv_heads, D), \
                {"context": (ax.rank * n, W)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                **extra}

    def mamba2():
        dl = cfg.ssm_expand * cfg.d_model // tp.size
        return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, dl + 2 * N),
                                    dtype=dtype, device=device),
                "ssd": torch.zeros((batch, _ssm_heads(cfg) // tp.size, P, N),
                                   dtype=torch.float32, device=device)}

    def one(i):
        kind = pattern[i % len(pattern)]
        if kind in "GLX":
            return attn(i, specs[i % len(pattern)])
        if kind == "M":
            return mamba2()
        if kind == "H":
            return {"mamba": mamba2(), "attn": attn(i, specs[0])}
        Hl = cfg.d_model // P // tp.size
        return {"tm_shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                        device=device),
                "cm_shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                        device=device),
                "wkv": torch.zeros((batch, Hl, P, P), dtype=torch.float32,
                                   device=device)}

    return {"layers": [one(i) for i in range(cfg.n_layers)], "pos": 0}


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
