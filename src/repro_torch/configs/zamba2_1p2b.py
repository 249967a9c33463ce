"""zamba2-1.2b [hybrid]: Mamba2 backbone + one weight-shared attention block
applied every 6 layers (arXiv:2411.15242)."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, vocab=32000,
        n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, act="swiglu", norm="rmsnorm",
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        hybrid_attn_every=6,
        subquadratic=True,  # SSM backbone; shared-attn KV grows but is 1/6 depth
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=6, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        hybrid_attn_every=3, dtype="float32", subquadratic=True,
    ).validate()
