"""whisper-base [audio]: 6L enc + 6L dec, conv frontend STUB — input_specs
provides precomputed frame embeddings (arXiv:2212.04356)."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, vocab=51865,
        n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, act="gelu", norm="layernorm",
        n_enc_layers=6, enc_len=1500, rope_theta=0.0,  # whisper: learned/abs
        tie_embeddings=True,
        subquadratic=False,
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, act="gelu", norm="layernorm",
        n_enc_layers=2, enc_len=16, rope_theta=0.0, dtype="float32",
    ).validate()
