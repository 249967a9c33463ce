"""Mamba2 SSD scan on Hopper, forward and backward: the wrapper of
``csrc/ssd_scan.cu``.

The port of ``repro.kernels.ssd_scan.ssd_scan_pallas``.  The kernels'
contract, design and bound are described in the CUDA source.
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
TILE = 32  # tokens per tile in the kernels (csrc/ssd_scan.cu's TILE)
MAX_SMEM = 232448
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
    return _lib_fn("ssd_scan_bwd", [ctypes.c_void_p] * 14
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])


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
    """Launch the backward kernels: (dx, d(dt), dB, dC), all float32, for
    the gradient ``dy`` (B, S, H, P) of y.  The tile states are recomputed
    into a scratch the wrapper allocates (none for one tile and no initial
    state), and dB/dC sum per-head partials in a fixed order."""
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
    nt = -(-s // TILE)
    states = (torch.empty((b, h, nt, p, n), **f32)
              if nt > 1 or init_state is not None else None)
    dx = torch.empty((b, s, h, p), **f32)
    ddt = torch.empty((b, s, h), **f32)
    parts = torch.empty((2, b, h, s, n), **f32)
    db = torch.empty((b, s, n), **f32)
    dc = torch.empty((b, s, n), **f32)
    err = _bwd_entry()(dy.data_ptr(), x.data_ptr(), dt.data_ptr(),
                       a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                       _ptr(init_state), _ptr(states), dx.data_ptr(),
                       ddt.data_ptr(), parts[0].data_ptr(),
                       parts[1].data_ptr(), db.data_ptr(), dc.data_ptr(),
                       b, s, h, p, n, _DTYPES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaError {err}")
    return dx, ddt, db, dc


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
