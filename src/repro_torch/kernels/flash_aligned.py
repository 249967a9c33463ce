"""Aligned flash attention on Hopper: the wrapper of
``csrc/flash_aligned.cu``.

The port of ``repro.kernels.flash_attention``'s aligned mode
(``_flash_kernel``): a whole query sequence attends to a whole key
sequence, positions from 0 on both axes, causal and/or windowed, with kv
tiles outside the band skipped.  The kernel's design and bound are
described in the CUDA source.  Its plain PyTorch version is
``kernels.ref.flash_attention_ref``; ``kernels.ops`` chooses between the
two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the Hopper path's tiling (csrc/flash_aligned.cu, namespace wg): a CTA of
# three warpgroups over 128 query rows of one head, K/V tiles of WG_BN rows
# (64 past D 128) in a ring of two stages, one 64-column TMA box a row per
# 64 of the padded head dim
WG_BM = WG_BN = 128
WG_STAGES = 2
WG_THREADS = 384
# the float32 path's tiling (namespace tf): four warps over 64 query rows,
# 32-row K/V tiles double-buffered, float32 rows of Q and K padded to D + 8
# words and of V to D + 4
TF_BM, TF_BN, TF_STAGES, TF_THREADS = 64, 32, 2, 128
PLAN_KEYS = ("CTAs", "cluster", "threads", "smem_bytes", "registers",
             "stages")
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("flash_aligned").flash_aligned_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def path(d: int, dtype: torch.dtype) -> str:
    """The kernel ``flash_aligned_fwd`` runs for this head dim and dtype
    (by shape, never by failure): "tf32" for float32, "wgmma" for bf16 D
    64, 128 and 144 .. 256, "fma" for bf16 D 16 .. 48 and 80 .. 112."""
    if dtype == torch.float32:
        return "tf32"
    return "wgmma" if d in (64, 128) or d > 128 else "fma"


def wgmma_tiles(d: int) -> dict:
    """The wgmma path's tiles for head dim ``d``: ``dp`` (d padded to whole
    64-column TMA boxes, whose padding TMA zero-fills and the kernel never
    stores), ``bn`` (kv rows a tile: 128 up to 128 columns, else 64, so the
    output accumulator and the scores fit 240 registers) and ``cw`` (the
    columns of one output wgmma: 128 at dp 128, else 64)."""
    dp = -(-d // 64) * 64
    return dict(dp=dp, bn=WG_BN if dp <= 128 else 64,
                cw=128 if dp == 128 else 64)


def wgmma_smem(d: int) -> int:
    """Dynamic shared memory a CTA of the wgmma path asks for: Q, two K and
    two V stages at the padded head dim, nine mbarriers and 1024 bytes to
    align the base."""
    t = wgmma_tiles(d)
    return WG_BM * t["dp"] * 2 + 2 * WG_STAGES * t["bn"] * t["dp"] * 2 + 8 * (
        1 + 4 * WG_STAGES) + 1024


def tf32_smem(d: int) -> int:
    """Dynamic shared memory a CTA of the float32 path asks for: Q and two
    (K, V) stages in float32 rows of d + 8 words (Q, K) and d + 4 (V)."""
    return 4 * (TF_BM * (d + 8) + TF_STAGES * TF_BN * (2 * d + 12))


def _schedule(sq: int, sk: int, bm: int, bn: int, causal: bool,
              window: int) -> list:
    nq = -(-sq // bm)
    order = []
    for y in range(nq):
        q0 = (nq - 1 - y) * bm
        q_last = min(q0 + bm, sq) - 1
        hi = min(sk, q_last + 1) if causal else sk
        first = max(0, q0 - window + 1) if window > 0 else 0
        lo = first // bn * bn
        n = -(-(hi - lo) // bn) if hi > first else 0
        tiles = []
        for i in range(n):
            kt = lo + i * bn
            full = (kt + bn <= sk
                    and (not causal or kt + bn - 1 <= q0)
                    and (window <= 0 or kt > q0 + bm - 1 - window))
            tiles.append((kt, not full))
        order.append(dict(q0=q0, tiles=tiles))
    return order


def wgmma_schedule(b: int, sq: int, sk: int, hq: int, *, causal: bool = True,
                   window: int = 0, d: int = 128) -> dict:
    """The wgmma path's launch as ``csrc/flash_aligned.cu`` makes it: grid
    (Hq B, ceil(Sq / 128)), and for each ``blockIdx.y`` in launch order the
    query tile it owns (the last first, so the longest causal bands start
    first) with its kv tiles [(start, masked)]: the tiles of
    ``wgmma_tiles(d)["bn"]`` rows of the band its rows can see, ``masked``
    when some (row, key) pair of the tile is not visible (the diagonal, the
    window edge, keys past Sk); the others skip the mask.  A model for the
    CPU tests and the card's geometry check; the kernel does not call
    it."""
    bn = wgmma_tiles(d)["bn"]
    return dict(grid=(hq * b, -(-sq // WG_BM)), threads=WG_THREADS, bn=bn,
                order=_schedule(sq, sk, WG_BM, bn, causal, window))


def tf32_schedule(b: int, sq: int, sk: int, hq: int, *, causal: bool = True,
                  window: int = 0) -> dict:
    """The float32 path's launch, as ``wgmma_schedule`` describes the
    wgmma path's: grid (Hq B, ceil(Sq / 64)), longest bands first, 32-row
    kv tiles and which of them are masked."""
    return dict(grid=(hq * b, -(-sq // TF_BM)), threads=TF_THREADS, bn=TF_BN,
                order=_schedule(sq, sk, TF_BM, TF_BN, causal, window))


def plan(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
         dtype: torch.dtype) -> dict:
    """The launch the kernel would make for these shapes, from the CUDA
    library (``flash_aligned_plan``), without making it: CTAs, cluster,
    threads, shared memory, registers a thread (the compiled kernel's) and
    K/V stages."""
    fn = build.load("flash_aligned").flash_aligned_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = fn(b, sq, sk, hq, hkv, d, _DTYPES[dtype], out)
    if err:
        raise RuntimeError(f"flash_aligned_plan failed: cudaError {err}")
    return dict(zip(PLAN_KEYS, out))


def flash_attention_aligned_cuda(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
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
    if min(b, sq, sk, hq, hkv) < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head dim {d} must be a multiple of 16 in [16, 256]")
    if b > 65535 or hq > 65535:
        raise ValueError(f"batch {b} and query heads {hq} must be <= 65535")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device.type != "cuda" or t.device != q.device for t in (k, v)) \
            or q.device.type != "cuda":
        raise ValueError("q, k and v must lie on one CUDA device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("inputs must start on a 16-byte boundary")
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, hq, hkv, d, int(bool(causal)), int(window),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_aligned_fwd launch failed: cudaError {err}")
    return out
