"""Architecture configuration and the model-zoo public surface.

Every assigned architecture is described by a single :class:`ArchConfig`;
``src/repro/configs/<id>.py`` instantiate them with the exact published
dimensions, and each provides a ``reduced()`` variant for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Configuration for one LM-family architecture.

    The same dataclass covers dense / MoE / SSM / hybrid / VLM / audio
    backbones; unused blocks stay at their zero defaults.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full attention
    # --- mlp ---
    d_ff: int = 0
    act: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    moe_start_layer: int = 0  # layers below this use the dense MLP
    dense_d_ff: int = 0  # d_ff of the dense layers in a MoE model
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False  # multi-token-prediction auxiliary head
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    d_conv: int = 4
    # --- hybrid (zamba2): one weight-shared attn block every k ssm layers ---
    hybrid_attn_every: int = 0
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_len: int = 0
    # --- VLM (paligemma) ---
    n_img_tokens: int = 0
    img_embed_dim: int = 0
    # --- serving ---
    # prompt tokens ingested per prefilling slot per serving tick (block
    # prefill); 1 = token-by-token.  A per-arch tuning knob: TTFT scales
    # ~1/B while per-tick prefill compute scales ~B, so memory-tight
    # targets may prefer smaller blocks.  ServeEngine(prefill_block=...)
    # overrides.
    serve_prefill_block: int = 8
    # paged KV cache (serving/paging.py): fixed-size pages in a flat
    # arena with per-slot page tables, instead of a max_len stripe per
    # slot.  kv_page_size is in tokens; kv_int8 packs pages to int8 with
    # per-token scales (pack on write / unpack on read).  Rolling
    # sliding-window buffers (window < max_len) and SSM state stay
    # contiguous — they are already O(window)/O(1).  ServeEngine
    # (kv_paging=... / kv_page_size=... / kv_int8=...) overrides.
    kv_paging: bool = False
    kv_page_size: int = 16
    kv_int8: bool = False
    # page reservation discipline: 'asyougo' admits on the prompt's page
    # demand and grows page-by-page in-scan (preempt-and-requeue on pool
    # exhaustion); 'worstcase' pins ceil(max_len/page_size) pages at
    # admission.  ServeEngine(reserve=...) overrides.
    kv_reserve: str = "asyougo"
    # --- numerics ---
    dtype: str = "bfloat16"
    # --- long-context capability (decides long_500k applicability) ---
    subquadratic: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def enc_feats_shape(self) -> Optional[Tuple[int, int]]:
        """Per-request encoder-input geometry the serving engine expects on
        ``Request.enc_feats`` (the config-stub frontend output): whisper
        frame embeddings ``(enc_len, d_model)``, SigLIP patch embeddings
        ``(n_img_tokens, img_embed_dim)``; None for decoder-only configs."""
        if self.is_encoder_decoder:
            return (self.enc_len, self.d_model)
        if self.family == "vlm":
            return (self.n_img_tokens, self.img_embed_dim)
        return None

    def validate(self) -> "ArchConfig":
        assert self.family in {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}
        assert self.serve_prefill_block >= 1
        assert self.kv_page_size >= 1
        assert self.kv_reserve in ("asyougo", "worstcase")
        if self.family == "audio":
            assert self.is_encoder_decoder and self.enc_len > 0
        if self.family == "vlm":
            assert self.n_img_tokens > 0 and self.img_embed_dim > 0
        if self.family in {"dense", "moe", "vlm", "audio"}:
            assert self.n_heads > 0 and self.head_dim > 0
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.family in {"ssm", "hybrid"}:
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        return self


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


# The four assigned shape cells for the LM-family pool.
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs; reason recorded when skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode is not sub-quadratic"
    return True, ""
