"""Paged block flash attention on Hopper: the wrapper of
``csrc/flash_paged.cu``.

The port of ``repro.kernels.flash_attention.flash_attention_paged_pallas``
(``_flash_paged_kernel``): a block of prompt tokens per slot attends
causally to that slot's rows of the paged KV cache, read through its page
table from the flat arena with no gather.  The kernel's design and bound
are described in the CUDA source.  Its plain PyTorch version is
``kernels.ref.flash_attention_paged_ref``; ``kernels.ops`` chooses between
the two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("flash_paged").flash_paged_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_paged_cuda(
    q: torch.Tensor,           # (B, Sq, Hq, D)
    k_pages: torch.Tensor,     # (n_pages, page_size, Hkv, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32
    *,
    q_offset: torch.Tensor,    # (B,) int32
    kv_len: torch.Tensor,      # (B,) int32
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (B, Sq, Hq, D) in
    q's dtype.  Raises on anything the kernel does not take (a page table
    too wide for its shared memory is refused by the launch)."""
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"expected q (B,Sq,Hq,D) and k == v pages "
                         f"(n_pages,page_size,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, sq, hq, d = q.shape
    n_pages, ps, hkv, dk = k_pages.shape
    if dk != d:
        raise ValueError(f"q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} disagree on head dim")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head dim {d} must be a multiple of 16 in [16, 256]")
    if (q.dtype not in _DTYPES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise TypeError(f"q and pages must share one dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != b):
        raise TypeError(f"page_table must be int32 of shape ({b}, max_pages), "
                        f"got {page_table.dtype} {tuple(page_table.shape)}")
    mp = page_table.shape[1]
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise TypeError(f"{name} must be int32 of shape ({b},), got "
                            f"{t.dtype} {tuple(t.shape)}")
    tensors = (q, k_pages, v_pages, page_table, q_offset, kv_len)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pages must be 16-byte aligned (the "
                         "kernel copies 16 bytes at a time)")
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        page_table.data_ptr(), q_offset.data_ptr(), kv_len.data_ptr(),
        b, sq, hq, hkv, d, n_pages, ps, mp, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_paged_fwd launch failed: cudaError {err}")
    return out
