"""Model assembly for serving: config -> params, KV cache, prefill/decode
``step``.

Counterpart of ``repro/model/lm.py`` for the layer kinds the port serves
today: G (global attention block) and L (sliding-window attention block).
The JAX package scans over stacked group params; here the layers are an
``nn.ModuleList`` walked by a Python loop, run eagerly.  Other layer kinds
(M, H, R, X), MoE, encoders and the features of the other families raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from .layers import (MLP, PDTYPE, Attention, AttnSpec, RMSNorm,
                     attn_cache_init, rope_dim, rope_tables)


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
        (pattern & set("MH"), "mamba2 layer kinds M/H", 3),
        ("R" in pattern, "rwkv6 layer kind R", 4),
        (cfg.n_experts, "MoE blocks", 5),
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
    bad = pattern - set("GL")
    if bad:
        raise ValueError(f"unknown layer kinds {sorted(bad)}")


# ---------------------------------------------------------------------------
# per-position static specs
# ---------------------------------------------------------------------------

def build_specs(cfg: ArchConfig) -> list[AttnSpec]:
    """One spec per position of ``cfg.layer_pattern``: L is windowed, G
    global; ``check_supported`` raises for any other kind."""
    check_supported(cfg)
    return [AttnSpec(window=cfg.sliding_window if ch == "L" else None,
                     softcap=cfg.attn_logit_softcap,
                     rope_theta=cfg.rope_theta)
            for ch in cfg.layer_pattern]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """A G or L layer: pre-norm attention and pre-norm MLP, residual."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, cfg: ArchConfig, spec: AttnSpec, rope, *,
                cache=None, pos: int = 0):
        x = x + self.attn(self.ln_attn(x), cfg, spec, rope, cache=cache,
                          pos=pos)
        return x + self.mlp(self.ln_mlp(x), cfg)


class LM(nn.Module):
    """Parameters of a served model, with the JAX package's names:
    ``embed`` (vocab_padded, d), ``ln_f``, and ``layers`` (one Block per
    layer).  Allocated uninitialised; see ``init_params``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        check_supported(cfg)
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_padded, cfg.d_model), dtype=PDTYPE,
                        device=device), requires_grad=False)
        self.ln_f = RMSNorm(cfg.d_model, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights drawn on ``device`` from a seeded ``torch.Generator``.

    Each weight is drawn in f32 at std 1/sqrt(fan_in) (the embedding at
    0.02) and cast to bf16, one tensor at a time, so the transient f32
    buffer is one tensor (under 1 GB at granite-8b's width).  Norm weights
    are f32 ones.  The numbers differ from the JAX package's; parity tests
    carry its weights across with ``convert.from_jax_params``.
    """
    device = resolve_device(device)
    params = LM(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in params.named_parameters():
        if p.dtype == torch.float32:
            p.fill_(1.0)
            continue
        std = 0.02 if name == "embed" else p.shape[0] ** -0.5   # fan_in
        p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32,
                            device=device).mul_(std))
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
    """{"layers": [dict(k, v) per layer], "pos": 0}.  The position counter
    is kept once, at top level, as a Python int.  The k/v tensors take the
    dtype of the weights (bf16 when served), since the attention kernels
    take one dtype for q, k and v."""
    device = resolve_device(device)
    specs = build_specs(cfg)
    P = len(cfg.layer_pattern)
    return {"layers": [attn_cache_init(cfg, specs[i % P], batch, max_seq,
                                       device, dtype=params.embed.dtype)
                       for i in range(cfg.n_layers)],
            "pos": 0}


@torch.no_grad()
def step(params: LM, cfg: ArchConfig, cache, tokens):
    """Prefill (S > 1, from an empty cache) or decode (S = 1) step.

    tokens: (B, S) integer ids.  Returns (logits of the last position over
    the padded vocab, cache).  The cache's tensors are updated in place
    and its ``pos`` advanced by S; the same dict is returned.
    """
    specs = build_specs(cfg)
    S = tokens.shape[1]
    pos = cache["pos"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(pos, pos + S, device=x.device)
    ropes = {}
    P = len(cfg.layer_pattern)
    for i, layer in enumerate(params.layers):
        spec = specs[i % P]
        if spec.rope_theta not in ropes:
            ropes[spec.rope_theta] = rope_tables(positions, rope_dim(cfg),
                                                 spec.rope_theta)
        x = layer(x, cfg, spec, ropes[spec.rope_theta],
                  cache=cache["layers"][i], pos=pos)
    logits = lm_head(params, cfg, x[:, -1:])[:, 0]
    cache["pos"] = pos + S
    return logits, cache
