"""Cached block flash attention on Hopper: the wrapper of
``csrc/flash_cached.cu``.

The port of ``repro.kernels.flash_attention``'s cached mode
(``_flash_cached_kernel``): a block of prompt tokens per slot attends to
that slot's contiguous KV cache from its own cursor.  The kernel's design
and bound are described in the CUDA source.  Its plain PyTorch version is
``kernels.ref.flash_attention_cached_ref``; ``kernels.ops`` chooses between
the two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None

# csrc/flash_block.cuh's tiles: query rows a CTA, cache rows a logical kv
# tile, CTAs a cluster at most, and the dynamic shared memory of one block
BM, BN, MAX_SPLIT, SMEM_MAX = 64, 64, 8, 232448


def block_plan_model(b: int, sq: int, hq: int, hkv: int, d: int,
                     dtype: torch.dtype, rows: tuple) -> dict:
    """The launch kernels 2 and 4 make (``flash_block.cuh``'s ``launch``),
    computed on the host: ``CTAs``, ``cluster``, ``threads``,
    ``smem_bytes`` (dynamic), ``stages`` (the keys of the C entries'
    ``*_plan`` but registers), and ``path`` (``"mma"``: tensor cores, every
    bf16 head dim; ``"fma"``: f32) and ``q_tile`` (where the MMA path reads
    Q's fragments: ``"registers"`` up to D 128, ``"shared"`` past it).
    ``rows`` is the row source: ``("contig", Sk)`` or ``("paged",
    page_size, max_pages)``."""
    mma = dtype == torch.bfloat16
    elt = 2 if mma else 4
    ldk = d + 16 // elt                   # a staged K/V row, +16 bytes
    stage = 2 * BN * ldk * elt            # K + V
    q_shared = mma and d > 128
    q_bytes = (BM * ldk * elt if q_shared else 0) if mma else \
        4 * (BM * (d + 1) + BM * (BN + 1))

    def fixed(stages):
        return q_bytes + 4 * (4 * BM + MAX_SPLIT * BM) + 4 * stages * BN

    stages = 2 if mma or 2 * stage + fixed(2) <= 200 * 1024 else 1
    kind, *geom = rows
    tiles = -(-(geom[0] if kind == "contig" else geom[0] * geom[1]) // BN)
    run_ints = 0  # PagedRows::run_ints of a rank's longest run
    if kind == "paged":
        ps, mp = geom
        run_ints = min(-(-(-(-tiles // MAX_SPLIT) * BN) // ps) + 1, mp)
    cluster = 1
    while cluster < MAX_SPLIT and cluster < tiles:
        cluster *= 2
    return {"CTAs": -(-(hq // hkv * sq) // BM) * cluster * hkv * b,
            "cluster": cluster, "threads": 128 if mma else 256,
            "smem_bytes": stages * stage + fixed(stages) + 4 * run_ints,
            "stages": stages, "path": "mma" if mma else "fma",
            "q_tile": ("shared" if q_shared else "registers") if mma
            else "f32 shared"}


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("flash_cached").flash_cached_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_cached_cuda(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    q_offset: torch.Tensor,  # (B,) int32
    kv_len: torch.Tensor,    # (B,) int32
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (B, Sq, Hq, D) in
    q's dtype.  Raises on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Sq,Hq,D) and k == v (B,Sk,Hkv,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head dim {d} must be a multiple of 16 in [16, 256]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise TypeError(f"{name} must be int32 of shape ({b},), got "
                            f"{t.dtype} {tuple(t.shape)}")
    tensors = (q, k, v, q_offset, kv_len)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned (the kernel "
                         "copies 16 bytes at a time)")
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_offset.data_ptr(), kv_len.data_ptr(),
        b, sq, sk, hq, hkv, d, int(bool(causal)), int(window),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_cached_fwd launch failed: cudaError {err}")
    return out
