"""Zamba2 7B: Mamba2 backbone with two alternating *shared* attention
blocks invoked every 6th layer over concat(hidden, embeddings)
[arXiv:2411.15242].  81 layers = 3 groups x 27 (pattern below)."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112,
    layer_pattern="MMMMMH" * 4 + "MMM",      # len 27; 81 = 3 groups
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-7b-reduced", n_layers=6, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
        layer_pattern="MMMMMH", ssm_state=16, ssm_head_dim=16, max_seq=256)
