"""Model assembly: config -> params; the training forward (``forward``,
``loss_fn``, ``chunked_ce``); caches and the prefill/decode ``step``.

Counterpart of ``repro/model/lm.py``, for every layer kind:

  G  global attention block        L  sliding-window attention block
  X  attention block + gated cross-attention over a memory
  M  mamba2 block                  H  mamba2 + shared attention (zamba2)
  R  rwkv6 block (time-mix + channel-mix)

A G, L or X layer's FFN is the MLP or, with ``cfg.n_experts``, the MoE
(plus the MLP as arctic's dense residual), each sublayer optionally
post-normed (gemma).  The memory an X layer attends to is the stub
frontend's embeddings projected to d (llama-vision) or the output of the
encoder over them (whisper), built once by ``init_cache``.  The JAX
package scans over stacked group params; here the layers are an
``nn.ModuleList`` walked by a Python loop, run eagerly.

Parameters are made with ``requires_grad=False``, which serving keeps;
a trainer turns them on (``params.requires_grad_(True)``).  The attention,
gather, scan and grouped-matmul kernels differentiate through their own
backward kernels on the card.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from .layers import (MLP, PDTYPE, Attention, AttnSpec, RMSNorm, _f32,
                     _rounded, _weight, attn_cache_init, rope_dim,
                     rope_tables)
from .mamba2 import Mamba2, mamba2_cache_init
from .moe import MoE
from .rwkv6 import RWKV6, rwkv6_cache_init


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no GPU present
    raises rather than carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return device


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a layer kind the model does not know."""
    bad = set(cfg.layer_pattern) - set("GLXMHR")
    if bad:
        raise ValueError(f"unknown layer kinds {sorted(bad)}")


# ---------------------------------------------------------------------------
# per-position static specs
# ---------------------------------------------------------------------------

def build_specs(cfg: ArchConfig) -> list[AttnSpec]:
    """One spec per position of ``cfg.layer_pattern``: L is windowed, G, X
    and H global at ``cfg.global_rope_theta`` (gemma3's 50 x theta, which
    the JAX package sets by the name), and the attention-free M and R take
    the default spec."""
    check_supported(cfg)
    theta = cfg.global_rope_theta or cfg.rope_theta
    return [AttnSpec(window=cfg.sliding_window,
                     softcap=cfg.attn_logit_softcap,
                     rope_theta=cfg.rope_theta) if ch == "L"
            else AttnSpec(softcap=cfg.attn_logit_softcap, rope_theta=theta)
            if ch in "GXH" else AttnSpec()
            for ch in cfg.layer_pattern]


def shared_indices(cfg: ArchConfig) -> list[int]:
    """For each position of the pattern, the zamba2 shared block an H layer
    there uses: the count of H layers before it in its group, mod 2 (the
    count restarts in every group, as ``h_idx`` in the JAX package)."""
    return [cfg.layer_pattern[:i].count("H") % 2
            for i in range(len(cfg.layer_pattern))]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """A G or L layer: pre-norm attention and a pre-norm FFN, residual,
    each sublayer's output normed again under ``cfg.post_norms``.  The FFN
    is the MLP, or with ``cfg.n_experts`` the MoE, plus the MLP under
    ``cfg.dense_residual`` (arctic).  Also whisper's encoder layers."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, device)
        if cfg.n_experts:
            self.moe = MoE(cfg, device)
        if not cfg.n_experts or cfg.dense_residual:
            self.mlp = MLP(cfg, device)
        if cfg.post_norms:
            self.ln_attn_post = RMSNorm(cfg.d_model, device)
            self.ln_mlp_post = RMSNorm(cfg.d_model, device)

    def ffn(self, h, cfg: ArchConfig):
        """The JAX package's ``_ffn``: (y, aux), aux the MoE's
        load-balance loss (f32) or 0.0 with no experts.  Serving drops
        aux, as ``repro.model.lm.step`` does; training adds it to the
        loss."""
        if not cfg.n_experts:
            return self.mlp(h, cfg), 0.0
        y, aux = self.moe(h, cfg)
        if cfg.dense_residual:
            y = y + self.mlp(h, cfg)
        return y, aux

    def self_attention(self, x, cfg: ArchConfig, spec: AttnSpec, rope,
                       cache, pos: int):
        a = self.attn(self.ln_attn(x), cfg, spec, rope, cache=cache,
                      pos=pos)
        if cfg.post_norms:
            a = self.ln_attn_post(a)
        return x + a

    def feed_forward(self, x, cfg: ArchConfig):
        f, aux = self.ffn(self.ln_mlp(x), cfg)
        if cfg.post_norms:
            f = self.ln_mlp_post(f)
        return x + f, aux

    def forward(self, x, cfg: ArchConfig, spec: AttnSpec, rope, *,
                cache=None, pos: int = 0):
        """-> (x, aux), aux as ``ffn``'s."""
        return self.feed_forward(
            self.self_attention(x, cfg, spec, rope, cache, pos), cfg)


class CrossBlock(Block):
    """An X layer: the G block with a gated cross-attention over the
    memory between its attention and its FFN.  The gate is an f32 scalar,
    zero at init as in the JAX package, so a fresh model's X layers add
    nothing until it is set.  With no memory the cross-attention is
    skipped."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__(cfg, device)
        self.ln_xattn = RMSNorm(cfg.d_model, device)
        self.xattn = Attention(cfg, device)
        self.xattn_gate = _f32((), device)

    def forward(self, x, cfg: ArchConfig, spec: AttnSpec, rope, *,
                cache=None, pos: int = 0, memory=None):
        x = self.self_attention(x, cfg, spec, rope, cache, pos)
        if memory is not None:
            xa = self.xattn(self.ln_xattn(x), cfg, spec, None,
                            kv_from=memory)
            x = x + torch.tanh(self.xattn_gate).to(x.dtype) * xa
        return self.feed_forward(x, cfg)


class MambaBlock(nn.Module):
    """An M layer: pre-norm mamba2, residual."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device)
        self.mamba = Mamba2(cfg, device)

    def forward(self, x, cfg: ArchConfig, cache=None):
        return x + self.mamba(self.ln(x), cfg, cache)


class SharedBlock(nn.Module):
    """One of zamba2's two shared attention + MLP blocks."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, device)
        self.mlp = MLP(cfg, device)


class HybridBlock(nn.Module):
    """An H layer: the mamba2 block, then a shared attention + MLP block
    over rmsnorm(concat(x, x0)) projected down from 2 d, projected back
    with this layer's own ``w_shared_out``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        self.mamba = Mamba2(cfg, device)
        self.ln = RMSNorm(d, device)
        self.ln_shared_in = RMSNorm(2 * d, device)
        self.w_shared_in = _weight((2 * d, d), device)
        self.w_shared_out = _weight((d, d), device)

    def forward(self, x, cfg: ArchConfig, spec: AttnSpec, rope, *,
                shared: SharedBlock, x0, cache=None, pos: int = 0):
        x = x + self.mamba(self.ln(x), cfg,
                           None if cache is None else cache["mamba"])
        h = self.ln_shared_in(torch.cat([x, x0], dim=-1)) @ self.w_shared_in
        a = shared.attn(h, cfg, spec, rope, pos=pos,
                        cache=None if cache is None else cache["attn"])
        a = a + shared.mlp(shared.ln_mlp(a), cfg)
        return x + a @ self.w_shared_out


class RWKVBlock(nn.Module):
    """An R layer: pre-norm time-mix and pre-norm channel-mix, each
    residual, each with its token-shift state."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ln_tm = RMSNorm(cfg.d_model, device)
        self.ln_cm = RMSNorm(cfg.d_model, device)
        self.rwkv = RWKV6(cfg, device)

    def forward(self, x, cfg: ArchConfig, cache=None):
        zeros = x.new_zeros((x.shape[0], 1, x.shape[2]))
        tm_shift, cm_shift, wkv = (zeros, zeros, None) if cache is None \
            else (cache["tm_shift"], cache["cm_shift"], cache["wkv"])
        y, tm_shift, wkv = self.rwkv.time_mix(self.ln_tm(x), cfg, tm_shift,
                                              wkv)
        x = x + y
        y, cm_shift = self.rwkv.chan_mix(self.ln_cm(x), cm_shift)
        if cache is not None:
            cache.update(tm_shift=tm_shift, cm_shift=cm_shift, wkv=wkv)
        return x + y


_BLOCKS = {"G": Block, "L": Block, "X": CrossBlock, "M": MambaBlock,
           "H": HybridBlock, "R": RWKVBlock}


class LM(nn.Module):
    """Parameters of a served model, with the JAX package's names:
    ``embed`` (vocab_padded, d), ``ln_f``, ``layers`` (one block per layer,
    of its kind in ``cfg.layer_pattern``); ``lm_head`` (d, vocab_padded)
    for an untied head; for zamba2, ``shared`` (the two shared attention +
    MLP blocks); for a model with a frontend, ``frontend_proj``
    (frontend_dim, d); for whisper, ``encoder`` (G blocks) and ``ln_enc``.
    Allocated uninitialised; see ``init_params``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        check_supported(cfg)
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_padded, cfg.d_model), dtype=PDTYPE,
                        device=device), requires_grad=False)
        self.ln_f = RMSNorm(cfg.d_model, device)
        pattern = cfg.layer_pattern
        self.layers = nn.ModuleList(
            _BLOCKS[pattern[i % len(pattern)]](cfg, device)
            for i in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.d_model, cfg.vocab_padded), device)
        if "H" in pattern:
            self.shared = nn.ModuleList(SharedBlock(cfg, device)
                                        for _ in range(2))
        if cfg.cross_attn_period or cfg.family in ("vlm", "audio"):
            self.frontend_proj = _weight((cfg.frontend_dim, cfg.d_model),
                                         device)
        if cfg.n_enc_layers:
            self.encoder = nn.ModuleList(Block(cfg, device)
                                         for _ in range(cfg.n_enc_layers))
            self.ln_enc = RMSNorm(cfg.d_model, device)


#: std of the normal draw where it is not 1/sqrt(fan_in), as in the JAX
#: package's init
_STD = {"embed": 0.02, "conv_w": 0.2, "w_B": 0.01, "u": 0.3, "router": 0.02}
#: constant parameters: norm weights and mamba2's skip D are ones, the
#: mamba2 dt bias and the X layers' cross-attention gate zeros, the rwkv6
#: decay base -6
_CONST = {"w": 1.0, "D": 1.0, "dt_bias": 0.0, "w_base": -6.0,
          "xattn_gate": 0.0}


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights drawn on ``device`` from a seeded ``torch.Generator``.

    Each weight is drawn in f32 and cast to its dtype, one tensor at a
    time, so the transient f32 buffer is one tensor (the largest,
    gemma2-27b's embedding, is 4.7 GB).  The distributions are the JAX package's: normal
    at std 1/sqrt(fan_in) unless ``_STD`` says otherwise (fan_in is
    ``shape[0]``, as the JAX package's ``_dense_init`` takes it: for the
    expert stacks (E, d, f) and (E, f, d) that is E), uniform on [0, 1)
    for the rwkv6 token-shift mixes ``mu``, ``A_log = log(linspace(1, 16,
    H))``, and the constants of ``_CONST``.  The f32 MoE router is drawn
    through bf16, as the JAX package draws it.  The numbers differ from the
    JAX package's; parity tests carry its weights across with
    ``convert.from_jax_params``.
    """
    device = resolve_device(device)
    params = LM(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _CONST:
            p.fill_(_CONST[leaf])
        elif leaf == "A_log":
            p.copy_(torch.log(torch.linspace(1.0, 16.0, p.shape[0],
                                             device=device)))
        elif leaf == "mu":
            p.copy_(torch.rand(p.shape, generator=gen, device=device))
        else:
            std = _STD.get(leaf, p.shape[0] ** -0.5)          # fan_in
            draw = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                               device=device).mul_(std)
            p.copy_(draw.to(PDTYPE) if leaf == "router" else draw)
    return params


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _embed(params: LM, cfg: ArchConfig, tokens):
    """tokens (B, S), ids below ``cfg.vocab`` -> (B, S, d).  gemma scales
    (``cfg.embed_scale``) by sqrt(d) rounded to the activations' dtype
    first, as the JAX package does: 68.0 for gemma2's 4608 in bf16, 62.0
    for gemma3's 3840."""
    B, S = tokens.shape
    x = ops.burst_gather(params.embed, tokens.reshape(-1))
    x = x.view(B, S, cfg.d_model)
    if cfg.embed_scale:
        x = x * _rounded(math.sqrt(cfg.d_model), x.dtype)
    return x


def _frontend(params: LM, embeddings):
    """Stub frontend embeddings (B, T, frontend_dim) projected to d and
    rounded to bf16, as the JAX package casts them.  They are taken in the
    weights' dtype, and with f32 weights the result goes back to f32 (the
    JAX package's promotion at the next product)."""
    w = params.frontend_proj
    return (embeddings.to(w.dtype) @ w).to(PDTYPE).to(w.dtype)


def _encode(params: LM, cfg: ArchConfig, frames):
    """Whisper's encoder over (stub) frame embeddings: non-causal G
    blocks with rope, then ``ln_enc``."""
    x = _frontend(params, frames)
    spec = AttnSpec(causal=False, rope_theta=cfg.rope_theta)
    rope = rope_tables(torch.arange(x.shape[1], device=x.device),
                       rope_dim(cfg), spec.rope_theta)
    for block in params.encoder:
        x, _ = block(x, cfg, spec, rope)
    return params.ln_enc(x)


def _memory(params: LM, cfg: ArchConfig, extra):
    """The memory the X layers attend to, or None: the encoder's output
    for ``extra["frames"]`` (whisper), the projected
    ``extra["vision"]`` (llama-vision)."""
    if cfg.n_enc_layers and extra is not None and "frames" in extra:
        return _encode(params, cfg, extra["frames"])
    if extra is not None and "vision" in extra:
        return _frontend(params, extra["vision"])
    return None


def lm_head(params: LM, cfg: ArchConfig, x):
    """Final norm, the tied or untied LM head, and the final softcap
    (``tanh(logits / c) * c`` op by op in the logits' dtype).  Returns
    logits over the PADDED vocab with pad rows masked to -1e30.  The bf16
    head is widened to f32 for f32 activations (``chunked_ce``), as JAX
    promotes it."""
    x = params.ln_f(x)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ w.to(x.dtype)
    if cfg.final_logit_softcap:
        c = _rounded(cfg.final_logit_softcap, logits.dtype)
        logits = torch.tanh(logits / c) * c
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


class _Layers:
    """Applies layer i of ``params`` by its kind, for ``forward`` and
    ``step``: ``layers(i, x, cache=None, pos=0) -> (x, aux)``, aux the MoE's
    load-balance loss or 0.0.  Rotary tables over ``positions`` are built
    once per theta, and only for a model with attention layers."""

    def __init__(self, params: LM, cfg: ArchConfig, positions, *, x0,
                 memory=None):
        self.params, self.cfg, self.positions = params, cfg, positions
        self.x0, self.memory = x0, memory
        self.specs = build_specs(cfg)
        self.shared_idx = shared_indices(cfg)
        self.ropes = {}

    def rope(self, spec: AttnSpec):
        if spec.rope_theta not in self.ropes:
            self.ropes[spec.rope_theta] = rope_tables(
                self.positions, rope_dim(self.cfg), spec.rope_theta)
        return self.ropes[spec.rope_theta]

    def __call__(self, i: int, x, *, cache=None, pos: int = 0):
        cfg, params = self.cfg, self.params
        j = i % len(cfg.layer_pattern)
        kind, spec, layer = cfg.layer_pattern[j], self.specs[j], \
            params.layers[i]
        if kind in "GL":
            return layer(x, cfg, spec, self.rope(spec), cache=cache, pos=pos)
        if kind == "X":
            return layer(x, cfg, spec, self.rope(spec), cache=cache, pos=pos,
                         memory=self.memory)
        if kind == "H":
            return layer(x, cfg, spec, self.rope(spec),
                         shared=params.shared[self.shared_idx[j]],
                         x0=self.x0, cache=cache, pos=pos), 0.0
        return layer(x, cfg, cache=cache), 0.0


# ---------------------------------------------------------------------------
# training forward and losses
# ---------------------------------------------------------------------------

def forward(params: LM, cfg: ArchConfig, tokens, *, extra=None,
            remat: bool = False):
    """The full-sequence forward of training: tokens (B, S) -> (logits
    (B, S, vocab) over the real vocab, in the weights' dtype; aux, the
    summed MoE load-balance loss, f32 0-d).

    ``extra`` takes the stub frontend's inputs, as ``init_cache`` does.
    With ``remat`` each layer group's activations are recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant) where the JAX
    package wraps its scanned group in ``jax.checkpoint``; the values and
    gradients are the same, and on the card each group's attention
    forwards launch twice.  aux is summed layer after layer, as the JAX
    package's scan carries it.  Like ``step``, it runs every layer: a
    config cut in depth to a count that is not a multiple of the pattern
    ends on a shorter group."""
    x0 = x = _embed(params, cfg, tokens)
    layer = _Layers(params, cfg, torch.arange(tokens.shape[1],
                                              device=x.device),
                    x0=x0, memory=_memory(params, cfg, extra))
    P = len(cfg.layer_pattern)

    def group(first, x, aux):
        for i in range(first, min(first + P, cfg.n_layers)):
            x, a = layer(i, x)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for first in range(0, cfg.n_layers, P):
        if remat:
            x, aux = checkpoint.checkpoint(group, first, x, aux,
                                           use_reentrant=False)
        else:
            x, aux = group(first, x, aux)
    return lm_head(params, cfg, x)[..., :cfg.vocab], aux


def loss_fn(params: LM, cfg: ArchConfig, batch, *, remat: bool = False):
    """Next-token cross entropy plus 0.01 x the MoE aux loss, f32 0-d.
    batch: {"tokens": (B, S + 1) ids, optionally "extra"}; the logits of
    positions 0..S-1 predict tokens 1..S, in f32."""
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, tokens, extra=batch.get("extra"),
                          remat=remat)
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tokens[:, 1:, None].long())[..., 0]
    return (logz - ll).mean() + 0.01 * aux


def chunked_ce(params: LM, cfg: ArchConfig, x, targets, mask=None, *,
               n_chunks: int = 8):
    """Memory-bounded cross entropy over hidden states x (B, S, d): the
    (tokens, vocab) logits are made one chunk of tokens at a time, in f32
    over the padded vocab (whose pad rows lm_head sets to -1e30).  Tokens
    are padded to ``n_chunks`` equal chunks, with weight 0; ``mask``
    weighs the tokens.  Returns sum((logz - ll) * mask) / max(sum(mask), 1)
    as the JAX package's unrolled chunk loop computes it."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    tf = targets.reshape(T).long()
    mf = (mask.reshape(T).float() if mask is not None
          else torch.ones(T, dtype=torch.float32, device=x.device))
    chunk = max(-(-T // n_chunks), 1)
    pad = chunk * n_chunks - T
    xf = nn.functional.pad(xf, (0, 0, 0, pad))
    tf = nn.functional.pad(tf, (0, pad))
    mf = nn.functional.pad(mf, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        lg = lm_head(params, cfg, xf[sl][None].float())[0]
        logz = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, tf[sl, None])[:, 0]
        total = total + ((logz - ll) * mf[sl]).sum()
    return total / torch.clamp(mf.sum(), min=1.0)


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_cache(params: LM, cfg: ArchConfig, batch, max_seq, device="cuda",
               extra=None):
    """{"layers": [one cache dict per layer], "pos": 0}.  By kind: G, L
    and X dict(k, v); M the mamba2 dict(conv, ssd); H dict(mamba, attn); R
    dict(tm_shift, cm_shift, wkv).  The position counter is kept once, at
    top level, as a Python int.  k/v, conv and token shifts take the dtype
    of the weights (bf16 when served), since each kernel takes one dtype
    for its activations; the ssd and wkv states are f32.

    extra: the stub frontend's inputs, ``{"vision": (B, T, frontend_dim)}``
    or ``{"frames": ...}``.  When given, ``cache["memory"]`` holds what the
    X layers attend to (``_memory``): whisper's encoder runs here, once."""
    device = resolve_device(device)
    specs = build_specs(cfg)
    dtype = params.embed.dtype
    pattern = cfg.layer_pattern

    def one(kind, spec):
        if kind in "GLX":
            return attn_cache_init(cfg, spec, batch, max_seq, device, dtype)
        if kind == "M":
            return mamba2_cache_init(cfg, batch, device, dtype)
        if kind == "H":
            # the JAX package sizes the H layers' caches by position 0's spec
            return {"mamba": mamba2_cache_init(cfg, batch, device, dtype),
                    "attn": attn_cache_init(cfg, specs[0], batch, max_seq,
                                            device, dtype)}
        return rwkv6_cache_init(cfg, batch, device, dtype)

    cache = {"layers": [one(pattern[i % len(pattern)],
                            specs[i % len(pattern)])
                        for i in range(cfg.n_layers)],
             "pos": 0}
    if extra:
        cache["memory"] = _memory(params, cfg, extra)
    return cache


@torch.no_grad()
def step(params: LM, cfg: ArchConfig, cache, tokens):
    """Prefill (S > 1, from an empty cache) or decode (S = 1) step.

    tokens: (B, S) integer ids.  Returns (logits of the last position over
    the padded vocab, cache).  The cache is updated in place (k/v written
    into its tensors, the recurrent states replaced in its dicts) and its
    ``pos`` advanced by S; the same dict is returned.
    """
    S = tokens.shape[1]
    pos = cache["pos"]
    x0 = x = _embed(params, cfg, tokens)
    layer = _Layers(params, cfg, torch.arange(pos, pos + S, device=x.device),
                    x0=x0, memory=cache.get("memory"))
    for i in range(cfg.n_layers):
        x, _ = layer(i, x, cache=cache["layers"][i], pos=pos)
    logits = lm_head(params, cfg, x[:, -1:])[:, 0]
    cache["pos"] = pos + S
    return logits, cache
