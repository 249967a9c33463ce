"""qwen2-1.5b [dense]: GQA kv=2, QKV bias (arXiv:2407.10671)."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, vocab=151936,
        n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, act="swiglu", norm="rmsnorm", qkv_bias=True,
        subquadratic=False,
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-smoke", family="dense",
        n_layers=3, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, qkv_bias=True, dtype="float32",
    ).validate()
