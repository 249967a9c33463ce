"""mamba2-1.3b [ssm]: attention-free SSD backbone (arXiv:2405.21060)."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, vocab=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        subquadratic=True,
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=4, d_model=64, vocab=256,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        dtype="float32", subquadratic=True,
    ).validate()
