"""Architecture configuration system (the port's own copy of
``repro/configs/base.py``; the port imports nothing of ``repro``).

Two fields are the port's own: ``embed_scale`` and ``global_rope_theta``
say what the JAX package decides from the config's name (a name starting
with "gemma" / "gemma3"), so that a renamed config keeps its arithmetic.

One ``ArchConfig`` describes everything the model builder needs.  Every
supported architecture provides a module with ``CONFIG`` (full-size, exact
public numbers) and ``reduced()`` (a tiny same-family config for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "vlm", "hybrid", "audio", "ssm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads

    # ---- attention flavour -------------------------------------------------
    rope_theta: float = 10_000.0
    #: "neox" full-dim rotary; "partial" = rotary on half the head dim
    #: (chatglm's 2d-RoPE applies rotary to half the dims);
    #: "learned" = learned positions (whisper); "none" = attention-free
    rope_style: str = "neox"
    #: sliding-window size for local layers (None = all global)
    sliding_window: int | None = None
    #: layer pattern string over a repeating group, e.g. "LG" (gemma2
    #: alternating), "LLLLLG" (gemma3 5:1), "G"*n (all global),
    #: "M"*5 + "H" (zamba2: mamba with every-6th hybrid), "X" = cross-attn
    #: inserted (vlm).
    layer_pattern: str = "G"
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    #: query scaling ("head_dim" default, gemma2 uses d_model/n_heads)
    query_scale: float | None = None
    #: rope theta of the global layers (G, X, H); None = ``rope_theta``
    #: (gemma3 runs them at 50 x its local theta)
    global_rope_theta: float | None = None

    # ---- MLP ----------------------------------------------------------------
    mlp_act: str = "silu"                # silu | gelu
    gated_mlp: bool = True

    # ---- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int | None = None          # default d_ff
    #: arctic: dense FFN residual in parallel with the MoE FFN
    dense_residual: bool = False

    # ---- SSM (mamba2 / rwkv6) -----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4

    # ---- enc-dec / multimodal ------------------------------------------------
    n_enc_layers: int = 0                # whisper encoder depth
    cross_attn_period: int = 0           # vlm: cross-attn every k layers
    frontend_tokens: int = 0             # stub modality tokens (audio/vision)
    frontend_dim: int = 0

    # ---- norms / misc ---------------------------------------------------------
    norm: str = "rmsnorm"
    post_norms: bool = False             # gemma2-style post-attn/post-mlp norm
    #: gemma: token embeddings times sqrt(d_model), rounded to the
    #: activations' dtype first
    embed_scale: bool = False
    tie_embeddings: bool = True
    max_seq: int = 524_288

    # ---- training memory plan --------------------------------------------------
    #: optimizer selected per memory budget (see DESIGN.md §6)
    optimizer: str = "adamw"             # adamw | adafactor

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ---- derived sizes ---------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a shard-friendly multiple of 256
        (logits for padded rows are masked to -inf in lm_head)."""
        return -(-self.vocab // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-flops)."""
        c = self
        emb = c.vocab * c.d_model * (1 if c.tie_embeddings else 2)
        per_layer = 0
        att = c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
        mlp_in = 2 * c.d_model * c.d_ff if c.gated_mlp else c.d_model * c.d_ff
        mlp = mlp_in + c.d_ff * c.d_model
        pat = c.layer_pattern
        for i in range(c.n_layers):
            kind = pat[i % len(pat)]
            if kind in ("G", "L", "X"):
                per_layer += att + mlp
                if kind == "X":
                    per_layer += att  # cross-attention
            elif kind == "M":
                d_in = c.ssm_expand * c.d_model
                per_layer += (c.d_model * (2 * d_in + 2 * c.ssm_state)
                              + d_in * c.d_model + d_in * 3)
            elif kind == "H":
                d_in = c.ssm_expand * c.d_model
                per_layer += (c.d_model * (2 * d_in + 2 * c.ssm_state)
                              + d_in * c.d_model + d_in * 3)
                per_layer += att + mlp  # shared block (counted once is fine)
            elif kind == "R":
                per_layer += 4 * c.d_model * c.d_model + 2 * c.d_model * c.d_ff
        if c.n_experts:
            moe_in = 2 * c.d_model * c.moe_d_ff if c.gated_mlp else \
                c.d_model * c.moe_d_ff
            moe = (moe_in + c.moe_d_ff * c.d_model) * c.n_experts \
                + c.d_model * c.n_experts
            delta = moe - mlp if not c.dense_residual else moe
            per_layer += delta * c.n_layers
        return int(emb + per_layer)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts)."""
        c = self
        if not c.n_experts:
            return self.param_count()
        full = self.param_count()
        moe_in = 2 * c.d_model * c.moe_d_ff if c.gated_mlp else \
            c.d_model * c.moe_d_ff
        expert = moe_in + c.moe_d_ff * c.d_model
        inactive = (c.n_experts - c.top_k) * expert * c.n_layers
        return int(full - inactive)
