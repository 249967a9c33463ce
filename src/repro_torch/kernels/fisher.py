"""Fused Fisher reduction (paper Eq. 2) on Hopper: the wrapper of
``csrc/fisher.cu``.

The port of ``repro.kernels.fisher.fisher_pallas``.  The kernel's contract,
design and bound are described in the CUDA source.  :func:`tapgrads_cuda`
is the tap-gradient route, always with a leading task axis (the
reference's ``jax.vmap`` of the probe adds a grid axis to the Pallas call):
one launch for a fleet's (T, L, B, C) stack with a per-task mask and valid
count, and T = 1 for one task's probe.  :func:`fisher_cuda` is the
materialised-activation form.  Their plain PyTorch versions are
``kernels.ref.fisher_tapgrads_ref`` and ``fisher_ref``; ``kernels.ops``
chooses between them and these wrappers by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the D == 1 route's launch (csrc/fisher.cu): RT threads a block, each
# owning VEC neighbouring columns of one layer, RU valid rows loaded ahead,
# the mask's valid rows compacted RCH at a time into shared memory
RT, RU, RCH = 128, 8, 1024
PLAN_KEYS = ("blocks", "threads", "vec", "rows_ahead", "rows_a_pass")
_fn = None
_tap_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("fisher").fisher_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _tap_entry():
    """``fisher_tapgrads_fwd(g, mask, n, out, T, L, N, C, dtype, stream,
    plan)``."""
    global _tap_fn
    if _tap_fn is None:
        fn = build.load("fisher").fisher_tapgrads_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _tap_fn = fn
    return _tap_fn


def rows_vec(c: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """Columns a thread of the D == 1 route: 16 bytes' worth (4 float32, 8
    bf16) when C is a multiple of that and the operands start on a 16-byte
    boundary, else 1."""
    v = 16 // (4 if dtype == torch.float32 else 2)
    return v if c % v == 0 and aligned else 1


def rows_plan(layers: int, n: int, c: int, dtype: torch.dtype,
              aligned: bool = True, tasks: Optional[int] = None) -> dict:
    """The D == 1 route's launch as ``csrc/fisher.cu`` makes it (a model
    for the CPU tests and the card's launch check; the kernel does not call
    it): ``owner(block, thread)`` is the (layer, first column) a thread
    owns, or None past the last column.  With ``tasks`` (the task-axis
    launch) the grid is (blocks, tasks), ``owner((block, task), thread)``
    is (task, layer, first column): every block lies inside one task."""
    vec = rows_vec(c, dtype, aligned)
    groups = c // vec
    blocks = -(-layers * groups // RT)

    def owner(block: int, thread: int):
        j = block * RT + thread
        if j >= layers * groups:
            return None
        return j // groups, (j % groups) * vec

    out = dict(blocks=blocks, threads=RT, vec=vec, rows_ahead=RU,
               rows_a_pass=RCH, owner=owner)
    if tasks is not None:
        def task_owner(block, thread):
            bx, t = block
            if not 0 <= t < tasks:
                raise IndexError(f"task {t} outside the grid's {tasks}")
            o = owner(bx, thread)
            return None if o is None else (t, *o)

        out.update(tasks=tasks, owner=task_owner)
    return out


def compact_rows(mask: Optional[torch.Tensor], n: int) -> list:
    """The rows the D == 1 route reads, pass by pass, as its first warp
    compacts them into shared memory: [(rows, weights)] for each pass of
    ``RCH`` rows, the rows whose mask is non-zero in increasing order, each
    with weight m^2 (every row with weight 1 without a mask)."""
    out = []
    for r0 in range(0, n, RCH):
        m = (torch.ones(min(RCH, n - r0)) if mask is None
             else mask[r0:r0 + RCH].float())
        keep = [r0 + i for i in range(m.numel()) if m[i] != 0]
        out.append((keep, [float(mask[r] ** 2) if mask is not None else 1.0
                           for r in keep]))
    return out


def plan(g: torch.Tensor) -> dict:
    """The launch the tap-gradient route would make for g (T, L, B, C)
    (its shape and alignment), from the CUDA library, without making it:
    ``PLAN_KEYS`` for the blocks of one task, and ``tasks``, the grid's
    second extent."""
    t, layers, n, c = g.shape
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = _tap_entry()(g.data_ptr(), None, None, None, t, layers, n, c,
                       _DTYPES[g.dtype], None, out)
    if err:
        raise RuntimeError(f"fisher_tapgrads_fwd's plan failed: cudaError "
                           f"{err}")
    return dict(zip(PLAN_KEYS, out), tasks=t)


def tapgrads_cuda(g: torch.Tensor, n: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the tap-gradient route on the current stream: g (T, L, B, C)
    float32 or bf16, n (T,) float32 valid counts and mask (T, B) float32 on
    the same card -> (T, L, C) float32, ``Σ_b m² g² / (2 n_t)`` per task,
    masked rows never read.  Raises on anything the kernel does not
    take."""
    if g.dim() != 4:
        raise ValueError(f"expected (T, L, B, C) tap gradients, got "
                         f"{tuple(g.shape)}")
    t, layers, b, c = g.shape
    if g.dtype not in _DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if min(t, layers, b, c) < 1:
        raise ValueError(f"empty operand {tuple(g.shape)}")
    if n.dtype != torch.float32 or tuple(n.shape) != (t,):
        raise TypeError(f"n must be float32 of shape ({t},), got {n.dtype} "
                        f"{tuple(n.shape)}")
    if mask is not None and (mask.dtype != torch.float32
                             or tuple(mask.shape) != (t, b)):
        raise TypeError(f"mask must be float32 of shape ({t}, {b}), got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    tensors = [x for x in (g, n, mask) if x is not None]
    if any(x.device.type != "cuda" or x.device != g.device for x in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((t, layers, c), dtype=torch.float32, device=g.device)
    err = _tap_entry()(
        g.data_ptr(), None if mask is None else mask.data_ptr(),
        n.data_ptr(), out.data_ptr(), t, layers, b, c, _DTYPES[g.dtype],
        torch.cuda.current_stream(g.device).cuda_stream, None)
    if err != 0:
        raise RuntimeError(f"fisher_tapgrads_fwd launch failed: cudaError "
                           f"{err}")
    return out


def fisher_cuda(
    g: torch.Tensor,
    a: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    scale: float,
    mask_norm: bool = False,
) -> torch.Tensor:
    """Launch the materialised-activation form on the current stream: a
    and g (N, D, C) -> (C,), ``out = scale · Σ_n m_n² (Σ_d a·g)²``, divided
    by ``max(Σ m, 1)`` when ``mask_norm``; rows with ``m == 0`` are never
    read.  Raises on anything the kernel does not take."""
    if a is None:
        raise ValueError("the (N, D, C) form needs the activation operand")
    if g.dim() != 3 or a.shape != g.shape:
        raise ValueError(f"expected 3-d g and a of the same shape, got "
                         f"{tuple(g.shape)} and {tuple(a.shape)}")
    if g.dtype not in _DTYPES or a.dtype != g.dtype:
        raise TypeError(f"a/g must share one dtype of float32 or bfloat16, "
                        f"got {a.dtype}, {g.dtype}")
    n, d, c = g.shape
    if min(n, d, c) < 1:
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
    out = torch.empty((c,), dtype=torch.float32, device=g.device)
    err = _entry()(
        a.data_ptr(), g.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        n, d, c, float(scale), int(bool(mask_norm)), _DTYPES[g.dtype],
        torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fisher_fwd launch failed: cudaError {err}")
    return out
