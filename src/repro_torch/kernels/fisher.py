"""Fused Fisher reduction (paper Eq. 2) on Hopper: the wrapper of
``csrc/fisher.cu``.

The port of ``repro.kernels.fisher.fisher_pallas``.  The kernel's contract,
design and bound are described in the CUDA source.  :func:`tapgrads_cuda`
is the tap-gradient route, always with a leading task axis (the
reference's ``jax.vmap`` of the probe adds a grid axis to the Pallas call):
one launch for a fleet's (T, L, B, C) stack with a per-task mask and valid
count, and T = 1 for one task's probe.  :func:`fisher_cuda` is the
materialised-activation form (its (N, D, C) kernel's launch:
:func:`general_plan`).  Their plain PyTorch versions are
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
# the (N, D, C) kernel's launch (csrc/fisher.cu, general_plan): at most GT
# threads a CTA, GSPLIT CTAs a cluster, GCH valid rows compacted a pass, a
# D-rank at least GDMIN d values, the grid at least GWAVE CTAs (the SMs)
# where the columns allow it
GT, GCH, GSPLIT, GWAVE, GDMIN = 256, 256, 8, 132, 128
GENERAL_PLAN_KEYS = ("blocks", "cluster", "threads_x", "threads_y", "vec",
                     "rows_a_chunk", "d_ranks", "row_ranks", "d_chunk",
                     "reducers")
_fn = None
_tap_fn = None
_plan_fn = None


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


def _plan_entry():
    """``fisher_general_plan(a, g, N, D, C, dtype, plan)``."""
    global _plan_fn
    if _plan_fn is None:
        fn = build.load("fisher").fisher_general_plan
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _plan_fn = fn
    return _plan_fn


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


def compact_rows(mask: Optional[torch.Tensor], n: int,
                 per_pass: int = RCH) -> list:
    """The rows the D == 1 route reads, pass by pass, as its first warp
    compacts them into shared memory: [(rows, weights)] for each pass of
    ``per_pass`` rows (``RCH``; the (N, D, C) kernel's is ``GCH``), the
    rows whose mask is non-zero in increasing order, each with weight m^2
    (every row with weight 1 without a mask)."""
    out = []
    for r0 in range(0, n, per_pass):
        m = (torch.ones(min(per_pass, n - r0)) if mask is None
             else mask[r0:r0 + per_pass].float())
        keep = [r0 + i for i in range(m.numel()) if m[i] != 0]
        out.append((keep, [float(mask[r] ** 2) if mask is not None else 1.0
                           for r in keep]))
    return out


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def general_plan(n: int, d: int, c: int, dtype: torch.dtype,
                 aligned: bool = True) -> dict:
    """The (N, D, C) kernel's launch as ``csrc/fisher.cu`` makes it (a
    model for the CPU tests and the card's launch check; the kernel does
    not call it).  A column tile of ``threads_x * vec`` columns is one
    cluster of ``cluster = d_ranks * row_ranks`` CTAs of ``threads_x *
    threads_y`` threads; rank (rn, rd) reads d in ``[rd * d_chunk, (rd + 1)
    * d_chunk)`` of the valid rows ``rn, rn + row_ranks, ...`` of each
    pass's compacted list, ``rows_a_chunk`` rows at a time; ``reducers``
    threads sum one (row, column) of a chunk over the d lanes.

    ``reads(block, thread, rows)`` gives what a thread loads, for the
    valid rows ``rows`` in order (``compact_rows``' rows, all passes):
    (its rows, its d values, its columns), each a list."""
    vec = rows_vec(c, dtype, aligned)
    nb = 16 // vec if vec > 1 else 8
    groups = c // vec
    sd_max = 1
    while sd_max < GSPLIT and -(-d // (2 * sd_max)) >= GDMIN:
        sd_max *= 2
    sn_max = min(GSPLIT, 1 << (max(1, n) - 1).bit_length())
    s_max = min(GSPLIT, sd_max * sn_max)
    hi = min(32, 1 << (groups - 1).bit_length())
    lo = min(4, hi)
    tx, s = next(((t, k) for t in (32, 16, 8, 4, 2, 1) if lo <= t <= hi
                  for k in (1, 2, 4, 8)
                  if k <= s_max and -(-groups // t) * k >= GWAVE),
                 (lo, s_max))
    sn = 1
    while 2 * sn <= s and 2 * sn * nb <= n:
        sn *= 2
    sd = min(s // sn, sd_max)
    sn = s // sd
    dc = -(-d // sd)
    ty = max(vec, min(GT // tx, _pow2_floor(dc)))
    ty = max(ty, 32 // tx)
    tiles = -(-groups // tx)
    ct = tx * vec

    def reads(block: int, thread: int, rows):
        if not (0 <= block < tiles * s and 0 <= thread < tx * ty):
            raise IndexError(f"({block}, {thread}) outside the launch")
        tile, rank = divmod(block, s)
        rn, rd = divmod(rank, sd)
        ty_, tx_ = divmod(thread, tx)
        c0 = tile * ct + tx_ * vec
        if c0 >= c:
            return [], [], []
        mine = []
        for p0 in range(0, n, GCH):  # each pass's list, dealt by row-rank
            in_pass = [r for r in rows if p0 <= r < p0 + GCH]
            mine += in_pass[rn::sn]
        lo_d = rd * dc
        return (mine, list(range(lo_d + ty_, min(d, lo_d + dc), ty)),
                list(range(c0, c0 + vec)))

    return dict(blocks=tiles * s, cluster=s, threads_x=tx, threads_y=ty,
                vec=vec, rows_a_chunk=nb, d_ranks=sd, row_ranks=sn,
                d_chunk=dc, reducers=max(1, ty // (nb * vec)), tiles=tiles,
                reads=reads)


def general_launch_plan(a: torch.Tensor, g: torch.Tensor) -> dict:
    """The launch the (N, D, C) kernel would make for a, g (their shape,
    dtype and alignment), from the CUDA library, without making it:
    ``GENERAL_PLAN_KEYS`` and ``registers``, a thread's, from the
    compiled kernel."""
    n, d, c = g.shape
    out = (ctypes.c_int * (len(GENERAL_PLAN_KEYS) + 1))()
    err = _plan_entry()(a.data_ptr(), g.data_ptr(), n, d, c,
                        _DTYPES[g.dtype], out)
    if err:
        raise RuntimeError(f"fisher_general_plan failed: cudaError {err}")
    return dict(zip((*GENERAL_PLAN_KEYS, "registers"), out))


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
