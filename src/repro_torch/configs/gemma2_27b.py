"""Gemma 2 27B: alternating local(4096)/global attention, attn softcap 50,
final softcap 30, post-norms, query scale 1/sqrt(d_model/n_heads)
[arXiv:2408.00118]."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256000, head_dim=128,
    layer_pattern="LG", sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,   # gemma2 scales by d_model/n_heads
    mlp_act="gelu", post_norms=True,
    rope_theta=1e4, embed_scale=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="gemma2-27b-reduced", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        sliding_window=32, query_scale=(64 / 4) ** -0.5, max_seq=256)
