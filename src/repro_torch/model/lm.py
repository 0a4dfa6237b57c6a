"""Model assembly for serving: config -> params, caches, prefill/decode
``step``.

Counterpart of ``repro/model/lm.py`` for the layer kinds the port serves
today:

  G  global attention block        L  sliding-window attention block
  M  mamba2 block                  H  mamba2 + shared attention (zamba2)
  R  rwkv6 block (time-mix + channel-mix)

A G or L layer's FFN is the MLP or, with ``cfg.n_experts``, the MoE (plus
the MLP as arctic's dense residual).  The JAX package scans over stacked
group params; here the layers are an ``nn.ModuleList`` walked by a Python
loop, run eagerly.  The X kind, encoders and the features of the other
families raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from .layers import (MLP, PDTYPE, Attention, AttnSpec, RMSNorm, _weight,
                     attn_cache_init, rope_dim, rope_tables)
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
    """Raise ``NotImplementedError`` for what the port does not serve yet."""
    pattern = set(cfg.layer_pattern)
    checks = [
        ("X" in pattern or cfg.n_enc_layers or cfg.cross_attn_period
         or cfg.frontend_tokens, "cross-attention, encoders, frontends", 6),
        (cfg.post_norms or cfg.final_logit_softcap
         or cfg.name.startswith("gemma") or not cfg.tie_embeddings,
         "post-norms, final softcap, gemma embedding scale, untied head", 6),
    ]
    for present, what, item in checks:
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} not ported yet; see ROADMAP.md, port "
                f"queue item {item}")
    bad = pattern - set("GLMHR")
    if bad:
        raise ValueError(f"unknown layer kinds {sorted(bad)}")


# ---------------------------------------------------------------------------
# per-position static specs
# ---------------------------------------------------------------------------

def build_specs(cfg: ArchConfig) -> list[AttnSpec]:
    """One spec per position of ``cfg.layer_pattern``: L is windowed, G and
    H global at ``cfg.rope_theta``, and the attention-free M and R take the
    default spec.  ``check_supported`` raises for kinds not ported."""
    check_supported(cfg)
    return [AttnSpec(window=cfg.sliding_window if ch == "L" else None,
                     softcap=cfg.attn_logit_softcap,
                     rope_theta=cfg.rope_theta) if ch in "GLH"
            else AttnSpec()
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
    """A G or L layer: pre-norm attention and a pre-norm FFN, residual.
    The FFN is the MLP, or with ``cfg.n_experts`` the MoE, plus the MLP
    under ``cfg.dense_residual`` (arctic)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, device)
        if cfg.n_experts:
            self.moe = MoE(cfg, device)
        if not cfg.n_experts or cfg.dense_residual:
            self.mlp = MLP(cfg, device)

    def ffn(self, h, cfg: ArchConfig):
        """The JAX package's ``_ffn``.  Serving drops the MoE's aux loss,
        as ``repro.model.lm.step`` does."""
        if not cfg.n_experts:
            return self.mlp(h, cfg)
        y, _ = self.moe(h, cfg)
        if cfg.dense_residual:
            y = y + self.mlp(h, cfg)
        return y

    def forward(self, x, cfg: ArchConfig, spec: AttnSpec, rope, *,
                cache=None, pos: int = 0):
        x = x + self.attn(self.ln_attn(x), cfg, spec, rope, cache=cache,
                          pos=pos)
        return x + self.ffn(self.ln_mlp(x), cfg)


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


_BLOCKS = {"G": Block, "L": Block, "M": MambaBlock, "H": HybridBlock,
           "R": RWKVBlock}


class LM(nn.Module):
    """Parameters of a served model, with the JAX package's names:
    ``embed`` (vocab_padded, d), ``ln_f``, ``layers`` (one block per layer,
    of its kind in ``cfg.layer_pattern``) and, for zamba2, ``shared`` (the
    two shared attention + MLP blocks).  Allocated uninitialised; see
    ``init_params``."""

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
        if "H" in pattern:
            self.shared = nn.ModuleList(SharedBlock(cfg, device)
                                        for _ in range(2))


#: std of the normal draw where it is not 1/sqrt(fan_in), as in the JAX
#: package's init
_STD = {"embed": 0.02, "conv_w": 0.2, "w_B": 0.01, "u": 0.3, "router": 0.02}
#: constant parameters: norm weights and mamba2's skip D are ones, the
#: mamba2 dt bias zeros, the rwkv6 decay base -6
_CONST = {"w": 1.0, "D": 1.0, "dt_bias": 0.0, "w_base": -6.0}


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights drawn on ``device`` from a seeded ``torch.Generator``.

    Each weight is drawn in f32 and cast to its dtype, one tensor at a
    time, so the transient f32 buffer is one tensor (under 1 GB at
    granite-8b's width).  The distributions are the JAX package's: normal
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
    """tokens (B, S), ids below ``cfg.vocab`` -> (B, S, d)."""
    B, S = tokens.shape
    x = ops.burst_gather(params.embed, tokens.reshape(-1))
    return x.view(B, S, cfg.d_model)


def lm_head(params: LM, cfg: ArchConfig, x):
    """Final norm + tied LM head.  Returns logits over the PADDED vocab
    with pad rows masked to -1e30."""
    logits = params.ln_f(x) @ params.embed.T
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def init_cache(params: LM, cfg: ArchConfig, batch, max_seq, device="cuda"):
    """{"layers": [one cache dict per layer], "pos": 0}.  By kind: G and L
    dict(k, v); M the mamba2 dict(conv, ssd); H dict(mamba, attn); R
    dict(tm_shift, cm_shift, wkv).  The position counter is kept once, at
    top level, as a Python int.  k/v, conv and token shifts take the dtype
    of the weights (bf16 when served), since each kernel takes one dtype
    for its activations; the ssd and wkv states are f32."""
    device = resolve_device(device)
    specs = build_specs(cfg)
    dtype = params.embed.dtype
    pattern = cfg.layer_pattern

    def one(kind, spec):
        if kind in "GL":
            return attn_cache_init(cfg, spec, batch, max_seq, device, dtype)
        if kind == "M":
            return mamba2_cache_init(cfg, batch, device, dtype)
        if kind == "H":
            # the JAX package sizes the H layers' caches by position 0's spec
            return {"mamba": mamba2_cache_init(cfg, batch, device, dtype),
                    "attn": attn_cache_init(cfg, specs[0], batch, max_seq,
                                            device, dtype)}
        return rwkv6_cache_init(cfg, batch, device, dtype)

    return {"layers": [one(pattern[i % len(pattern)],
                           specs[i % len(pattern)])
                       for i in range(cfg.n_layers)],
            "pos": 0}


@torch.no_grad()
def step(params: LM, cfg: ArchConfig, cache, tokens):
    """Prefill (S > 1, from an empty cache) or decode (S = 1) step.

    tokens: (B, S) integer ids.  Returns (logits of the last position over
    the padded vocab, cache).  The cache is updated in place (k/v written
    into its tensors, the recurrent states replaced in its dicts) and its
    ``pos`` advanced by S; the same dict is returned.
    """
    specs = build_specs(cfg)
    shared_idx = shared_indices(cfg)
    S = tokens.shape[1]
    pos = cache["pos"]
    x0 = x = _embed(params, cfg, tokens)
    positions = torch.arange(pos, pos + S, device=x.device)
    ropes = {}

    def rope(spec):
        """Rotary tables, built once per theta and only for a model with
        attention layers."""
        if spec.rope_theta not in ropes:
            ropes[spec.rope_theta] = rope_tables(positions, rope_dim(cfg),
                                                 spec.rope_theta)
        return ropes[spec.rope_theta]

    pattern = cfg.layer_pattern
    for i, layer in enumerate(params.layers):
        j = i % len(pattern)
        kind, spec, c = pattern[j], specs[j], cache["layers"][i]
        if kind in "GL":
            x = layer(x, cfg, spec, rope(spec), cache=c, pos=pos)
        elif kind == "H":
            x = layer(x, cfg, spec, rope(spec),
                      shared=params.shared[shared_idx[j]], x0=x0, cache=c,
                      pos=pos)
        else:
            x = layer(x, cfg, cache=c)
    logits = lm_head(params, cfg, x[:, -1:])[:, 0]
    cache["pos"] = pos + S
    return logits, cache
