"""Megatron-style tensor parallelism over a tp sub-group: what GSPMD does
for the JAX package when a layer's weights are sharded over the model
axis (``pipeline.param_specs`` says which dim of each, ``cut`` how).

  * attention: wq, wk, wv column-parallel, wo row-parallel.  A rank holds
    n_heads / tp query heads and the n_kv_heads / tp KV heads they read;
    with fewer KV heads than ranks (tp a multiple of them) it holds the one
    KV head its query heads read, the same columns of wk and wv as the
    tp / n_kv_heads ranks beside it (``kv_share``), whose gradients the
    step sums over those ranks (``sum_shared_grads``);
  * the gated MLP: w_up, w_gate column-parallel, w_down row-parallel;
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

X layers, MoE experts and whisper's encoder raise ``NotImplementedError``
naming ROADMAP item 8c under tp > 1; with tp = 1 every layer runs as
``repro_torch.model.lm`` runs it.  The MoE load-balance loss is taken
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
from repro_torch.model.layers import _rounded, apply_rope, sigmoid, silu
from repro_torch.model.mamba2 import _causal_conv
from repro_torch.model.rwkv6 import _mix, _token_shift
from .collectives import (Axis, all_gather, all_reduce, all_reduce_,
                          copy_to, gather_from, reduce_from, scatter_to,
                          sum_over)

ITEM_8C = "ROADMAP item 8c"
#: chunks of tokens in ``chunked_ce``, as ``lm.chunked_ce``'s default
CE_CHUNKS = 8


def check_tp(cfg: ArchConfig, tp: int) -> None:
    """Raise where ``cfg`` cannot run with its layers split over ``tp``
    ranks: ``NotImplementedError`` (naming 8c) for X layers, MoE experts or
    an encoder; ``ValueError`` where the query heads, the FFN, the padded
    vocab, the mamba2 or rwkv6 heads do not divide, or the KV heads
    neither divide tp nor are divided by it."""
    if tp == 1:
        return
    if cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: whisper's encoder over tp {tp} waits for "
            f"{ITEM_8C}")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE experts over tp {tp} wait for {ITEM_8C}")
    if "X" in cfg.layer_pattern:
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism (tp {tp}) over X layers "
            f"(cross-attention) waits for {ITEM_8C}")
    kinds = set(cfg.layer_pattern)
    sizes = [("d_ff", cfg.d_ff), ("vocab_padded", cfg.vocab_padded)]
    if kinds & set("GLH"):
        sizes.append(("n_heads", cfg.n_heads))
        if cfg.n_kv_heads % tp and tp % cfg.n_kv_heads:
            raise ValueError(f"{cfg.name}: n_kv_heads {cfg.n_kv_heads} "
                             f"neither divides over tp {tp} nor divides it")
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


def kv_share(cfg: ArchConfig, tp: int) -> int:
    """tp ranks that hold one KV head: tp / n_kv_heads where there are
    fewer KV heads than ranks, else 1."""
    return tp // cfg.n_kv_heads if cfg.n_kv_heads < tp else 1


def local_config(cfg: ArchConfig, tp: int) -> ArchConfig:
    """``cfg`` as one tp rank's attention and MLP see it: n_heads / tp,
    n_kv_heads / tp (1 with fewer KV heads than ranks) and d_ff / tp
    (head_dim and everything else unchanged)."""
    check_tp(cfg, tp)
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=max(cfg.n_kv_heads // tp, 1),
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


def share(cfg: ArchConfig, name: str, tp: int) -> int:
    """tp ranks that hold each piece of ``name``'s split runs: the KV
    projections' ``kv_share``, else 1."""
    parts = name.rsplit(".", 2)
    if parts[-1] in ("wk", "wv") and len(parts) > 1 and \
            parts[-2] in ("attn", "xattn"):
        return kv_share(cfg, tp)
    return 1


def shard(cfg: ArchConfig, name: str, t, dim: int, tp: Axis):
    """The whole parameter ``t``'s shard on this tp rank, cut along
    ``dim``."""
    n = tp.size // share(cfg, name, tp.size)
    pieces, off = [], 0
    for size, split in segments(cfg, name, t.shape[dim]):
        run = t.narrow(dim, off, size)
        pieces.append(run.chunk(n, dim)[tp.rank // (tp.size // n)]
                      if split else run)
        off += size
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


def local_runs(cfg: ArchConfig, name: str, t, dim: int, tp: int):
    """[(piece of the shard ``t`` along ``dim``, tp ranks that hold it)]:
    its split runs (``share`` ranks each) and its whole runs (all tp)."""
    step = share(cfg, name, tp)
    n = tp // step
    out, off = [], 0
    for length, split in segments(cfg, name, t.shape[dim] * n):
        local = length // n if split else length
        out.append((t.narrow(dim, off, local), step if split else tp))
        off += local
    return out


def unshard(cfg: ArchConfig, name: str, parts: list, dim: int):
    """The whole parameter from every tp rank's shard ``parts``, in rank
    order (the inverse of ``shard``)."""
    tp = len(parts)
    step = share(cfg, name, tp)
    runs = [local_runs(cfg, name, p, dim, tp) for p in parts]
    whole = []
    for i, (_, held) in enumerate(runs[0]):
        whole += [r[i][0] for r in runs[::step]] if held < tp else \
            [runs[0][i][0]]
    return whole[0] if len(whole) == 1 else torch.cat(whole, dim)


def sum_shared_grads(cfg: ArchConfig, grads: dict, kv: Axis,
                     tp: int) -> None:
    """Sum over the ranks that share a KV head (``kv``, ``kv_share`` of
    them) each one's gradient of that head's wk and wv columns, in place:
    each rank's is the gradient through its own query heads."""
    if kv.size > 1:
        all_reduce_([g for n, g in grads.items()
                     if share(cfg, n, tp) > 1], kv)


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
              tp: Axis, *, cache=None, pos: int = 0):
    """``layers.Attention`` over this rank's heads: its partial output
    (B, S, d), summed over tp by the caller.  A cache split by its length
    (one with a "context" entry) takes ``context_attention``."""
    if cache is not None and "context" in cache:
        return context_attention(attn, x, cfg, local, spec, rope, tp, cache,
                                 pos)
    return attn(copy_to(x, tp), local, spec, rope, cache=cache, pos=pos)


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


def block(layer, x, cfg: ArchConfig, local: ArchConfig, spec, rope,
          tp: Axis, *, cache=None, pos: int = 0, aux_fn=None):
    """A G or L layer (``lm.Block``) with its attention and MLP split over
    tp: -> (x, aux)."""
    a = attention(layer.attn, layer.ln_attn(x), cfg, local, spec, rope, tp,
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
           tp: Axis, *, shared, x0, cache=None, pos: int = 0):
    """``lm.HybridBlock`` over tp: the mamba2 by head, then the shared
    block, its input projection column-parallel and gathered, its
    attention and MLP as a G layer's, its output projection row-parallel
    on this rank's slice."""
    x = x + reduce_from(mamba(layer.mamba, layer.ln(x), cfg, tp,
                              None if cache is None else cache["mamba"]), tp)
    hin = layer.ln_shared_in(torch.cat([x, x0], dim=-1))
    h = gather_from(copy_to(hin, tp) @ layer.w_shared_in, tp, -1)
    a = reduce_from(attention(shared.attn, h, cfg, local, spec, rope, tp,
                              cache=None if cache is None else cache["attn"],
                              pos=pos), tp)
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


class Layers(lm._Layers):
    """``lm._Layers`` over one rank's params (a stage's layers, each split
    over tp): G and L layers through ``block``, M through ``mamba``, H
    through ``hybrid``, R through ``rwkv``; X layers as the model runs
    them (tp 1 only, ``check_tp``).  With tp = 1 every kind runs as the
    model runs it."""

    def __init__(self, params, cfg: ArchConfig, positions, *, x0,
                 memory=None, tp: Axis, data: Axis):
        super().__init__(params, cfg, positions, x0=x0, memory=memory)
        self.tp, self.local = tp, local_config(cfg, tp.size)
        self.aux_fn = data_parallel_aux(data)

    def __call__(self, i: int, x, *, cache=None, pos: int = 0):
        cfg, tp = self.cfg, self.tp
        j = i % len(cfg.layer_pattern)
        kind, spec, layer = cfg.layer_pattern[j], self.specs[j], \
            self.params.layers[i]
        if kind in "GL":
            return block(layer, x, cfg, self.local, spec, self.rope(spec),
                         tp, cache=cache, pos=pos, aux_fn=self.aux_fn)
        if tp.size == 1 or kind == "X":
            return super().__call__(i, x, cache=cache, pos=pos)
        if kind == "M":
            return x + reduce_from(mamba(layer.mamba, layer.ln(x), cfg, tp,
                                         cache), tp), 0.0
        if kind == "H":
            return hybrid(layer, x, cfg, self.local, spec, self.rope(spec),
                          tp, shared=self.params.shared[self.shared_idx[j]],
                          x0=self.x0, cache=cache, pos=pos), 0.0
        return rwkv(layer, x, cfg, tp, cache), 0.0


def init_cache(cfg: ArchConfig, tp: Axis, batch: int, max_seq: int,
               *, kv_modes, device, dtype):
    """One tp rank's serving cache (``lm.init_cache``'s structure): each
    attention layer's k and v by ``kv_modes[i]`` ("heads": its KV heads,
    W slots; "context": every KV head, its W / tp slots, with "context"
    (lo, W)); mamba2's conv state (its x channels, then B and C) and ssd
    state (its heads); rwkv6's token shifts whole and wkv state (its
    heads)."""
    specs = lm.build_specs(cfg)
    local = local_config(cfg, tp.size)
    D, P, N = cfg.head_dim, cfg.ssm_head_dim, cfg.ssm_state
    pattern = cfg.layer_pattern

    def attn(i, spec):
        W = max_seq if spec.window is None else min(spec.window, max_seq)
        if kv_modes[i] == "heads":
            shape, extra = (batch, W, local.n_kv_heads, D), {}
        else:
            n = W // tp.size
            shape, extra = (batch, n, cfg.n_kv_heads, D), \
                {"context": (tp.rank * n, W)}
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
        if kind in "GL":
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
