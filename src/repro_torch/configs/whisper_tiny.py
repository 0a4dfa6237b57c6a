"""Whisper-tiny backbone: 4-layer encoder + 4-layer causal decoder with
cross-attention [arXiv:2212.04356].  The conv audio frontend is a stub, as
in the JAX package: the caller passes precomputed frame embeddings
(B, T_frames, 384)."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865, head_dim=64,
    layer_pattern="X",                 # decoder layers cross-attend
    n_enc_layers=4, frontend_tokens=1500, frontend_dim=384,
    mlp_act="gelu", gated_mlp=False, tie_embeddings=True,
    rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-tiny-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
        n_enc_layers=2, frontend_tokens=32, frontend_dim=64, max_seq=256)
