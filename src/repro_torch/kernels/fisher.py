"""Fused Fisher reduction (paper Eq. 2) on Hopper: the wrapper of
``csrc/fisher.cu``.

The port of ``repro.kernels.fisher.fisher_pallas``.  The kernel's contract,
design and bound are described in the CUDA source.  Its plain PyTorch
versions are ``kernels.ref.fisher_ref`` and ``fisher_tapgrads_ref``;
``kernels.ops`` chooses between them and this wrapper by the tensors'
device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("fisher").fisher_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fisher_cuda(
    g: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    mask: Optional[torch.Tensor] = None,
    scale: float,
    mask_norm: bool = False,
    per_layer: bool = False,
) -> torch.Tensor:
    """Launch the kernel on the current stream.

    ``per_layer``: g (and a, if given) is (L, N, C), the result (L, C),
    each layer reduced over its own N rows.  Otherwise a and g are
    (N, D, C) and the result (C,).  ``out = scale · Σ_n m_n² (Σ_d a·g)²``,
    divided by ``max(Σ m, 1)`` when ``mask_norm``; rows with ``m == 0`` are
    never read.  Raises on anything the kernel does not take."""
    if g.dim() != 3 or (a is not None and a.shape != g.shape):
        raise ValueError(f"expected 3-d g and a of the same shape, got "
                         f"{tuple(g.shape)} and "
                         f"{None if a is None else tuple(a.shape)}")
    if a is None and not per_layer:
        raise ValueError("the (N, D, C) form needs the activation operand")
    if g.dtype not in _DTYPES or (a is not None and a.dtype != g.dtype):
        raise TypeError(f"a/g must share one dtype of float32 or bfloat16, "
                        f"got {None if a is None else a.dtype}, {g.dtype}")
    if per_layer:
        lead, n, c = g.shape
        d = 1
    else:
        n, d, c = g.shape
        lead = 1
    if min(lead, n, d, c) < 1:
        raise ValueError(f"empty operand {tuple(g.shape)}")
    if mask is not None and (mask.dtype != torch.float32
                             or tuple(mask.shape) != (n,)):
        raise TypeError(f"mask must be float32 of shape ({n},), got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    tensors = [t for t in (g, a, mask) if t is not None]
    if any(t.device.type != "cuda" or t.device != g.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((lead, c) if per_layer else (c,), dtype=torch.float32,
                      device=g.device)
    err = _entry()(
        None if a is None else a.data_ptr(), g.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        lead, n, d, c, float(scale), int(bool(mask_norm)), _DTYPES[g.dtype],
        torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fisher_fwd launch failed: cudaError {err}")
    return out
