"""starcoder2-3b [dense]: GQA kv=2, RoPE, GELU MLP, layernorm, biases
(arXiv:2402.19173)."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, vocab=49152,
        n_heads=24, n_kv_heads=2, head_dim=128,
        d_ff=12288, act="gelu", norm="layernorm", qkv_bias=True,
        subquadratic=False,
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-smoke", family="dense",
        n_layers=3, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, act="gelu", norm="layernorm", qkv_bias=True,
        dtype="float32",
    ).validate()
