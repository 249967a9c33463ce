"""Mamba2 SSD scan on Hopper, forward and backward: the wrapper of
``csrc/ssd_scan.cu``.

The port of ``repro.kernels.ssd_scan.ssd_scan_pallas``.  The kernels'
contract, design and bound are described in the CUDA source;
:func:`fwd_geometry` and :func:`bwd_geometry` are their launch models.
:class:`SSDScanFn` makes the pair one differentiable operation: its
forward launches ``ssd_scan_fwd`` and its backward ``ssd_scan_bwd`` (the
JAX package takes this gradient from XLA's autodiff of ``ssd_chunked``).
The plain PyTorch version is ``kernels.ref.ssd_scan_ref``;
``kernels.ops.ssd_scan`` chooses between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32  # tokens per tile of the backward (csrc/ssd_scan.cu's TILE)
FWD_TILE = 64  # tokens per tile of the forward (FT)
FWD_THREADS = 256
MAX_HEADS = 8  # heads a forward CTA takes at most
MAX_SMEM = 232448
HALF_SM_SMEM = 233472 // 2 - 1024  # a CTA that fits twice in an SM
MAX_CLUSTER = 8  # heads a backward cluster combines at most (the portable size)
# kernels the backward entry has launched in this process, as it reports
# them (the fused backward, plus the group reduction when H > 8)
bwd_kernels = 0
_fns = {}


def _lib_fn(name: str, argtypes, restype=ctypes.c_int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("ssd_scan"), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[name] = fn
    return fn


def _entry():
    return _lib_fn("ssd_scan_fwd", [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _bwd_entry():
    return _lib_fn("ssd_scan_bwd", [ctypes.c_void_p] * 12
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)


def _ldw(n: int, r: int) -> int:
    """n words padded to r more than a multiple of 32 (``ldw``)."""
    return n + (r + 32 - n % 32) % 32


def fwd_smem_bytes(p: int, n: int, elt: int, heads: int, stages: int,
                   state: bool) -> int:
    """Dynamic shared memory of a forward CTA of ``heads`` heads for inputs
    of ``elt`` bytes (``fwd_smem`` in the CUDA source): ``stages`` staging
    areas of the B and C tiles (rows padded to 4 words past a multiple of
    32) and the heads' x (padded to 8) in the inputs' type and their dt;
    then G, three per-head vectors and, with ``state``, the heads' (P, N)
    states in float32."""
    wb, wx = _ldw(n * elt // 4, 4), _ldw(heads * p * elt // 4, 8)
    return (4 * stages * FWD_TILE * (2 * wb + wx + heads)
            + 4 * FWD_TILE * _ldw(FWD_TILE, 4) + 4 * 3 * heads * FWD_TILE
            + (4 * heads * p * _ldw(n, 4) if state else 0))


def fwd_geometry(b: int, s: int, h: int, p: int, n: int, elt: int,
                 init: bool = False, final: bool = False) -> dict:
    """The forward's launch at these dims, as ``csrc/ssd_scan.cu``'s
    ``fwd_geometry`` sets it: tiles of 64 tokens; the states kept (``state``)
    only when some tile needs one (more than one tile, an initial state or
    a final state asked for); two staging areas when there are two tiles or
    more and they fit; and ``heads`` a CTA, the largest power of two up to
    8 dividing H whose CTA fits twice in an SM (233,472 B, 1 KB reserved a
    CTA), else the largest that fits once.  None when nothing fits."""
    nt = -(-s // FWD_TILE)
    state = nt > 1 or init or final
    for stages in ((2, 1) if nt > 1 else (1,)):
        for cap in (HALF_SM_SMEM, MAX_SMEM):
            c = MAX_HEADS
            while c >= 1:
                smem = fwd_smem_bytes(p, n, elt, c, stages, state)
                if h % c == 0 and smem <= cap:
                    return dict(ctas=b * (h // c), heads=c,
                                threads=FWD_THREADS, tiles=nt,
                                stages=stages, state=state, smem_bytes=smem)
                c //= 2
    return None


def fwd_plan(b: int, s: int, h: int, p: int, n: int, dtype: torch.dtype,
             init: bool = False, final: bool = False) -> dict:
    """The forward launch the CUDA library would make at these dims
    (``ssd_scan_fwd_plan``), without making it: CTAs, heads a CTA, threads,
    shared memory, registers a thread, staging areas and whether the
    states are kept."""
    fn = _lib_fn("ssd_scan_fwd_plan", [ctypes.c_int] * 8 + [ctypes.c_void_p])
    keys = ("CTAs", "heads", "threads", "smem_bytes", "registers", "stages",
            "state")
    out = (ctypes.c_int * len(keys))()
    err = fn(b, s, h, p, n, _DTYPES[dtype], int(init), int(final), out)
    if err:
        raise RuntimeError(f"ssd_scan_fwd_plan failed: cudaError {err}")
    return dict(zip(keys, out))


def bwd_geometry(b: int, s: int, h: int) -> dict:
    """The backward's launch and scratch at these dims, as
    ``csrc/ssd_scan.cu`` computes them: one CTA a (b, h) in clusters of
    ``cluster`` consecutive heads (the largest divisor of H up to 8), whose
    dB/dC tiles combine in the cluster into one partial a (b, group, s);
    ``groups`` = H / cluster partials summed by the group reduction (none
    with one group); ``state_slots`` tile states in the scratch (those
    entering tiles 1 .. nt - 2; the last tile's stays on chip)."""
    cl = min(MAX_CLUSTER, h)
    while h % cl:
        cl -= 1
    nt = -(-s // TILE)
    return dict(ctas=b * h, cluster=cl, groups=h // cl, tiles=nt,
                state_slots=max(0, nt - 2), launches=1 + (h // cl > 1))


def bwd_smem_bytes(p: int, n: int, elt: int) -> int:
    """Dynamic shared memory a backward CTA needs (``bwd_smem`` in the
    CUDA source) for inputs of ``elt`` bytes: the state and its adjoint, B,
    C and the head's dB/dC tiles, x, u and dy, W, G and R, the epilogues'
    row partials, seven per-row vectors and one slot a warp, float32, each
    row padded to 4 words more than a multiple of 32 (the fragment loads'
    banks); then the staging area of the next tile's x, B, C, dy and dt."""
    ctp, ctn = -(-p // 8), -(-n // 8)
    ln, lp, lt = (w + (36 - w % 32) % 32 for w in (n, p, TILE))
    return (4 * (2 * p * ln + 4 * TILE * ln + 3 * TILE * lp + 3 * TILE * lt
                 + TILE * (2 * ctp + ctn) + 7 * TILE + 16)
            + TILE * (p + 2 * n) * elt + 4 * TILE * p + 4 * TILE)


def bwd_plan(b: int, s: int, h: int, p: int, n: int,
             dtype: torch.dtype) -> dict:
    """The backward launch the CUDA library would make at these dims
    (``ssd_scan_bwd_plan``), without making it: CTAs, cluster, threads,
    shared memory, registers a thread and the tile states in the
    scratch."""
    fn = _lib_fn("ssd_scan_bwd_plan", [ctypes.c_int] * 6 + [ctypes.c_void_p])
    keys = ("CTAs", "cluster", "threads", "smem_bytes", "registers",
            "state_slots")
    out = (ctypes.c_int * len(keys))()
    err = fn(b, s, h, p, n, _DTYPES[dtype], out)
    if err:
        raise RuntimeError(f"ssd_scan_bwd_plan failed: cudaError {err}")
    return dict(zip(keys, out))


def combine_heads(per_head: torch.Tensor, cluster: int,
                  finish_order=None) -> torch.Tensor:
    """The backward's fixed-order sum over heads of ``per_head`` (B, H, S,
    N), float32, as the kernels add: within each cluster of ``cluster``
    heads in rank order, then the H / cluster group partials in group
    order.  ``finish_order`` is the order the clusters compute their
    partials in (any: they are stored by group, then summed in group
    order).  A model for the CPU tests; the kernels never call it."""
    b, h, s, n = per_head.shape
    groups = [None] * (h // cluster)
    for g in (range(h // cluster) if finish_order is None else finish_order):
        acc = torch.zeros((b, s, n), dtype=torch.float32)
        for r in range(cluster):
            acc = acc + per_head[:, g * cluster + r].float()
        groups[g] = acc
    out = torch.zeros((b, s, n), dtype=torch.float32)
    for part in groups:
        out = out + part
    return out


def _smem(p: int, n: int, backward: bool) -> int:
    return _lib_fn("ssd_scan_smem", [ctypes.c_int] * 3,
                   ctypes.c_longlong)(p, n, int(backward))


def _check(x, dt, a, bmat, cmat, init_state, chunk: int) -> None:
    """Raise on anything the kernels do not take."""
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bmat.dim() != 3:
        raise ValueError(f"expected x (B,S,H,P), dt (B,S,H), a (H,), B/C "
                         f"(B,S,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(bmat.shape)}")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if (tuple(dt.shape) != (b, s, h) or tuple(a.shape) != (h,)
            or tuple(bmat.shape) != (b, s, n) or cmat.shape != bmat.shape):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B "
                         f"{tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    if min(b, s, h, p, n) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, N {n}")
    if p % 4 or n % 4:
        raise ValueError(f"the kernels block the state by 4: P={p} and N={n} "
                         "must be multiples of 4")
    q = min(int(chunk), s)
    if q < 1 or s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q} (ssd_chunked asserts S % Q == 0)")
    if (x.dtype not in _DTYPES or bmat.dtype != x.dtype
            or cmat.dtype != x.dtype):
        raise TypeError(f"x, B and C must share one dtype of float32 or "
                        f"bfloat16, got {x.dtype}, {bmat.dtype}, "
                        f"{cmat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32, got {dt.dtype}, "
                        f"{a.dtype}")
    tensors = [x, dt, a, bmat, cmat]
    if init_state is not None:
        if (init_state.dtype != torch.float32
                or tuple(init_state.shape) != (b, h, p, n)):
            raise TypeError(f"init_state must be float32 of shape "
                            f"{(b, h, p, n)}, got {init_state.dtype} "
                            f"{tuple(init_state.shape)}")
        tensors.append(init_state)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if any(t.data_ptr() % 4 for t in tensors):
        raise ValueError("inputs must start on a 4-byte boundary (the "
                         "backward stages them 4 bytes a copy)")
    for backward in (False, True):
        need = _smem(p, n, backward)
        if need > MAX_SMEM:
            raise ValueError(f"state width P={p}, N={n} needs {need} B of "
                             f"shared memory a block, above {MAX_SMEM}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ssd_scan_fwd_cuda(x, dt, a, bmat, cmat, *, chunk: int,
                      init_state: Optional[torch.Tensor] = None,
                      want_state: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on the current stream: (y float32 (B, S,
    H, P), final state float32 (B, H, P, N) or None unless
    ``want_state``).  Raises on anything the kernel does not take."""
    _check(x, dt, a, bmat, cmat, init_state, chunk)
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    fin = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
           if want_state else None)
    err = _entry()(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                   bmat.data_ptr(), cmat.data_ptr(), _ptr(init_state),
                   y.data_ptr(), _ptr(fin), b, s, h, p, n, _DTYPES[x.dtype],
                   _stream(x))
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: cudaError {err}")
    return y, fin


def ssd_scan_bwd_cuda(dy, x, dt, a, bmat, cmat, *, chunk: int,
                      init_state: Optional[torch.Tensor] = None):
    """Launch the backward: (dx, d(dt), dB, dC), all float32, for the
    gradient ``dy`` (B, S, H, P) of y.  One kernel rebuilds the tile states
    itself (a scratch only for the tiles between the first and the last,
    :func:`bwd_geometry`) and combines dB/dC over each cluster of heads; a
    second sums the cluster groups in a fixed order when there are more
    than one."""
    global bwd_kernels
    _check(x, dt, a, bmat, cmat, init_state, chunk)
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if dy.dtype != torch.float32 or dy.shape != x.shape:
        raise TypeError(f"dy must be float32 of shape {tuple(x.shape)}, got "
                        f"{dy.dtype} {tuple(dy.shape)}")
    if dy.device != x.device:
        raise ValueError("dy must lie on x's device")
    dy = dy.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    geo = bwd_geometry(b, s, h)
    states = (torch.empty((b, h, geo["state_slots"], p, n), **f32)
              if geo["state_slots"] else None)
    part = (torch.empty((2, b, geo["groups"], s, n), **f32)
            if geo["groups"] > 1 else None)
    dx = torch.empty((b, s, h, p), **f32)
    ddt = torch.empty((b, s, h), **f32)
    dbc = torch.empty((2, b, s, n), **f32)
    launched = ctypes.c_int(0)
    err = _bwd_entry()(dy.data_ptr(), x.data_ptr(), dt.data_ptr(),
                       a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                       _ptr(init_state), _ptr(states), dx.data_ptr(),
                       ddt.data_ptr(), _ptr(part), dbc.data_ptr(),
                       b, s, h, p, n, _DTYPES[x.dtype], _stream(x),
                       ctypes.byref(launched))
    bwd_kernels += launched.value
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaError {err}")
    return dx, ddt, dbc[0], dbc[1]


class SSDScanFn(torch.autograd.Function):
    """y = SSD scan of (x, dt, a, B, C) from ``init_state``, through the
    forward kernel; its backward is the backward kernel.  Returns (y
    float32, final state float32 or None); the final state is not
    differentiable.  ``a`` and ``init_state`` get no gradient: asking for
    one raises instead of returning a wrong one (``a`` comes from
    ``a_log``, which no TinyTrain delta touches)."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, init_state, chunk, want_state):
        for name, t in (("a", a), ("init_state", init_state)):
            if t is not None and t.requires_grad:
                raise NotImplementedError(
                    f"the SSD scan kernels give no gradient for {name}")
        y, fin = ssd_scan_fwd_cuda(x, dt, a, bmat, cmat, chunk=chunk,
                                   init_state=init_state,
                                   want_state=want_state)
        ctx.save_for_backward(x, dt, a, bmat, cmat, init_state)
        ctx.chunk = chunk
        if fin is not None:
            ctx.mark_non_differentiable(fin)
        return y, fin

    @staticmethod
    def backward(ctx, dy, _dfin):
        from . import ops  # late: ops imports this module

        x, dt, a, bmat, cmat, init_state = ctx.saved_tensors
        dx, ddt, db, dc = ssd_scan_bwd_cuda(dy, x, dt, a, bmat, cmat,
                                            chunk=ctx.chunk,
                                            init_state=init_state)
        ops.ssd_scan.bwd_launches += 1
        return (dx.to(x.dtype), ddt, None, db.to(bmat.dtype),
                dc.to(cmat.dtype), None, None, None)
