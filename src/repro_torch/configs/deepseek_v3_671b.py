"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed experts top-8, MTP
(arXiv:2412.19437).  First 3 layers dense (d_ff 18432); experts d_ff 2048."""
from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, vocab=129280,
        n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=2048, act="swiglu", norm="rmsnorm",
        n_experts=256, n_shared_experts=1, top_k=8, d_expert=2048,
        moe_start_layer=3, dense_d_ff=18432, capacity_factor=1.25,
        mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        mtp=True, tie_embeddings=False,
        subquadratic=False,
    ).validate()


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-smoke", family="moe",
        n_layers=4, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, n_experts=8, n_shared_experts=1, top_k=2, d_expert=64,
        moe_start_layer=1, dense_d_ff=128,
        mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        mtp=True, tie_embeddings=False, dtype="float32",
    ).validate()
