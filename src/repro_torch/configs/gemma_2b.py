"""gemma-2b [dense]: GeGLU, head_dim 256, MQA (arXiv:2403.08295)."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, vocab=256000,
        n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, act="geglu", norm="rmsnorm",
        subquadratic=False,
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="gemma-smoke", family="dense",
        n_layers=3, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, act="geglu", dtype="float32",
    ).validate()
