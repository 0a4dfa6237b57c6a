"""IBM Granite 3.0 MoE (3B total / 800M active): 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64,
    layer_pattern="G",
    n_experts=40, top_k=8, moe_d_ff=512,
    rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-moe-3b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=64, moe_d_ff=64, vocab=256,
        head_dim=16, n_experts=8, top_k=4, max_seq=256)
