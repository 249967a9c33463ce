"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention
(arXiv:2401.04088)."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, vocab=32000,
        n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, act="swiglu", norm="rmsnorm",
        n_experts=8, top_k=2, d_expert=14336, capacity_factor=1.25,
        sliding_window=4096, tie_embeddings=False,
        subquadratic=True,  # SWA bounds attention + KV cache
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mixtral-smoke", family="moe",
        n_layers=3, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, n_experts=4, top_k=2, d_expert=128,
        sliding_window=32, tie_embeddings=False, dtype="float32",
        subquadratic=True,
    ).validate()
