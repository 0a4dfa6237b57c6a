"""Gemma 3 12B: 5:1 local:global attention (window 1024), 128k context,
global layers at rope theta 1M [hf:google/gemma-3-1b-pt family].
long_500k is served with the ring-buffered local caches; only the 8 global
layers hold full-length KV."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=256,
    layer_pattern="LLLLLG", sliding_window=1024,
    mlp_act="gelu", post_norms=True,
    rope_theta=2e4, global_rope_theta=2e4 * 50, embed_scale=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-12b-reduced", n_layers=6, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        sliding_window=32, max_seq=256)
