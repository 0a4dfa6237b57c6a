"""IBM Granite 8B (code): llama-architecture dense [arXiv:2405.04324]."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152, head_dim=128,
    layer_pattern="G",
    rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-8b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        max_seq=256)
