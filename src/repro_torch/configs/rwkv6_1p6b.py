"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay WKV
recurrence [arXiv:2404.05892]."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab=65536, head_dim=64,
    layer_pattern="R", ssm_head_dim=64,
    gated_mlp=False, rope_style="none",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="rwkv6-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
        ssm_head_dim=16, max_seq=256)
