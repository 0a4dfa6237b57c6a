"""Snowflake Arctic (480B): dense-MoE hybrid — 128 experts top-2 with a
parallel dense FFN residual [hf:Snowflake/snowflake-arctic-base].

At ~480 B parameters (~960 GB in bf16) it fits neither one card nor
four; the port serves it only at its reduced size until the distributed
port (ROADMAP port queue item 8)."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128,
    layer_pattern="G",
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    rope_theta=1e6, optimizer="adafactor",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="arctic-480b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, moe_d_ff=96, vocab=256,
        head_dim=16, n_experts=8, top_k=2, max_seq=256)
