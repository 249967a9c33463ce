"""Int8 error-feedback quantisation on Hopper: the wrapper of
``csrc/grad_quant.cu``.

The port of ``repro.kernels.grad_quant.grad_quant_pallas``: one tensor's
global absmax, then its int8 codes and quantisation residual, in two
launches with no host read.  The kernel's contract, design and bound are
described in the CUDA source.  Its plain PyTorch version is
``kernels.ref.grad_quant_ref``; ``kernels.ops`` chooses between the two by
the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("grad_quant").grad_quant_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def grad_quant_cuda(g: torch.Tensor, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: (q int8 of g's shape, scale
    0-d float32, new_err float32 of g's shape).  Raises on anything the
    kernel does not take."""
    if g.shape != err.shape:
        raise ValueError(f"g {tuple(g.shape)} and err {tuple(err.shape)} "
                         "must have one shape")
    if g.numel() < 1:
        raise ValueError("grad_quant of an empty tensor has no absmax")
    if g.dtype not in _DTYPES or err.dtype != torch.float32:
        raise TypeError(f"g must be float32 or bfloat16 and err float32, got "
                        f"{g.dtype}, {err.dtype}")
    if (g.device.type != "cuda" or err.device != g.device):
        raise ValueError("g and err must lie on one CUDA device")
    if not (g.is_contiguous() and err.is_contiguous()):
        raise ValueError("g and err must be contiguous")
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    new_err = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    scratch = torch.empty((2,), dtype=torch.float32, device=g.device)
    rc = _entry()(g.data_ptr(), err.data_ptr(), q.data_ptr(),
                  new_err.data_ptr(), scratch.data_ptr(), g.numel(),
                  _DTYPES[g.dtype],
                  torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grad_quant_fwd launch failed: cudaError {rc}")
    return q, scratch[1], new_err
