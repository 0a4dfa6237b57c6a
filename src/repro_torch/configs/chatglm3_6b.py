"""ChatGLM3-6B: 2d-RoPE (rotary on half the head dims), extreme GQA (kv=2)
[arXiv:2406.12793]."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, head_dim=128,
    layer_pattern="G", rope_style="partial",
    mlp_act="silu", rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="chatglm3-6b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        max_seq=256)
