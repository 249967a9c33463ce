"""Int8 error-feedback quantisation on Hopper: the wrapper of
``csrc/grad_quant.cu``.

The port of ``repro.kernels.grad_quant.grad_quant_pallas``: one tensor's
global absmax, then its int8 codes and quantisation residual, in one
launch with no memset and no host read.  The kernel's contract, design and
bound are described in the CUDA source; :func:`plan_model` is its choice
of path and grid.  Its plain PyTorch version is
``kernels.ref.grad_quant_ref``; ``kernels.ops`` chooses between the two by
the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 512
UNIT = 16  # elements a thread takes at once (16 codes a store)
MIN_PER_CTA = 8192  # at most this many elements: one CTA, no grid barrier
MAX_SMEM = 232448
CAP = (MAX_SMEM - 256) // 4 // UNIT * UNIT  # g32 floats a CTA holds
TWO_PASS_PER_SM = 2
MAX_CTAS = 1024  # slots in the scratch
PATHS = ("one CTA", "on chip", "two passes")
_fns = {}


def _lib_fn(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("grad_quant"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _entry():
    return _lib_fn("grad_quant_fwd", [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def capacity(sms: int = 132) -> int:
    """The most elements the on-chip path takes: g32 in the shared memory
    of one CTA on each of ``sms`` SMs."""
    return sms * CAP


def plan_model(n: int, sms: int = 132) -> dict:
    """The kernel's path and grid for n elements (``gq_geometry`` in the
    CUDA source): one CTA up to ``MIN_PER_CTA`` elements; on chip up to
    :func:`capacity`, min(SMs, ceil(n / MIN_PER_CTA)) CTAs each over a
    slice of ``per`` elements (whole units) held in its shared memory; two
    passes beyond, 2 CTAs an SM striding over the units."""
    if n <= MIN_PER_CTA:
        per = -(-n // UNIT) * UNIT
        return dict(path=0, ctas=1, threads=THREADS, per=n, smem_bytes=4 * per)
    if n <= capacity(sms):
        ctas = min(sms, -(-n // MIN_PER_CTA))
        per = -(-(-(-n // ctas)) // UNIT) * UNIT
        return dict(path=1, ctas=ctas, threads=THREADS, per=per,
                    smem_bytes=4 * per)
    return dict(path=2, ctas=sms * TWO_PASS_PER_SM, threads=THREADS, per=0,
                smem_bytes=0)


def grad_quant_plan(n: int, dtype: torch.dtype) -> dict:
    """The launch the CUDA library would make for n elements
    (``grad_quant_plan``), without making it: path, CTAs, threads, shared
    memory, registers a thread and the card's SMs."""
    fn = _lib_fn("grad_quant_plan", [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p])
    keys = ("path", "ctas", "threads", "smem_bytes", "registers", "sms")
    out = (ctypes.c_int * len(keys))()
    err = fn(n, _DTYPES[dtype], out)
    if err:
        raise RuntimeError(f"grad_quant_plan failed: cudaError {err}")
    return dict(zip(keys, out))


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
    if g.data_ptr() % 16 or err.data_ptr() % 16:
        raise ValueError("g and err must start on a 16-byte boundary (the "
                         "kernel reads them 16 bytes a load)")
    if (g.device.type != "cuda" or err.device != g.device):
        raise ValueError("g and err must lie on one CUDA device")
    if not (g.is_contiguous() and err.is_contiguous()):
        raise ValueError("g and err must be contiguous")
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    new_err = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    scratch = torch.empty((2 + MAX_CTAS,), dtype=torch.float32,
                          device=g.device)
    rc = _entry()(g.data_ptr(), err.data_ptr(), q.data_ptr(),
                  new_err.data_ptr(), scratch.data_ptr(), g.numel(),
                  _DTYPES[g.dtype],
                  torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grad_quant_fwd launch failed: cudaError {rc}")
    return q, scratch[1], new_err
