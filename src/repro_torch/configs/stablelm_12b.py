"""stablelm-12b [dense]: GQA kv=8 (hf:stabilityai/stablelm-2-12b family)."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, vocab=100352,
        n_heads=32, n_kv_heads=8, head_dim=160,
        d_ff=13824, act="swiglu", norm="layernorm",
        tie_embeddings=False,
        subquadratic=False,
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="stablelm-smoke", family="dense",
        n_layers=3, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, norm="layernorm", tie_embeddings=False, dtype="float32",
    ).validate()
