"""Llama 3.2 Vision 11B backbone: 40 decoder layers with gated
cross-attention image layers every 5th layer [hf:meta-llama/
Llama-3.2-11B-Vision].  The vision tower is a stub, as in the JAX package:
the caller passes precomputed patch embeddings (B, 1601, 1280)."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128,
    layer_pattern="GGGXG",            # X = cross-attention layer (8 total)
    cross_attn_period=5, frontend_tokens=1601, frontend_dim=1280,
    rope_theta=5e5, tie_embeddings=False,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="llama-vision-reduced", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        frontend_tokens=16, frontend_dim=32, max_seq=256)
