"""paligemma-3b [vlm]: SigLIP frontend (stub) + gemma decoder
(arXiv:2407.07726).  input_specs supplies precomputed patch embeddings."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, vocab=257216,
        n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, act="geglu", norm="rmsnorm",
        n_img_tokens=256, img_embed_dim=1152,
        subquadratic=False,
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="paligemma-smoke", family="vlm",
        n_layers=3, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, act="geglu",
        n_img_tokens=8, img_embed_dim=32, dtype="float32",
    ).validate()
