"""Bytes and operations a kernel call needs, from its shapes alone: a
frozen copy of the port's own count (``chip_smoke.py``'s ``ssd_work``),
so that a change to the program cannot move the yardstick."""
from __future__ import annotations

SSD_TILE = 32  # the tile the operation count is taken over


def ssd_work(b, s, h, p, n, elt, backward, zero_init=True):
    """(bytes, operations) of one SSD scan call at these dims, with no
    final state asked for: each input read once and each output written
    once (x, B and C of ``elt`` bytes, dt, a, y and the gradients float32,
    dx/dB/dC back in x's dtype), and the multiply-adds of the tile
    algebra on this data (two operations each, tile by tile of 32 tokens;
    the state terms skipped where the state is known to be zero or no
    output needs it)."""
    bshp, bsh, bsn = b * s * h * p, b * s * h, b * s * n
    tiles = [min(SSD_TILE, s - t0) for t0 in range(0, s, SSD_TILE)]
    pairs = SSD_TILE * (SSD_TILE + 1) // 2
    if not backward:
        nbytes = bshp * elt + 4 * bsh + 4 * h + 2 * bsn * elt + 4 * bshp
        macs = 0
        for t, rows in enumerate(tiles):
            macs += pairs * n + p * rows * (rows + 1) // 2
            macs += (0 if t == 0 and zero_init else rows * n * p)
            macs += SSD_TILE * p * n if t < len(tiles) - 1 else 0
        return nbytes, 2 * macs * b * h
    nbytes = (4 * bshp + bshp * elt + 4 * bsh + 4 * h + 2 * bsn * elt
              + bshp * elt + 4 * bsh + 2 * bsn * elt)
    macs = 0
    for t, rows in enumerate(tiles):
        state_in = not (t == 0 and zero_init)
        ds = t < len(tiles) - 1
        macs += SSD_TILE * p * n if ds else 0                # recompute
        macs += pairs * (n + p)                              # W and dy.u
        macs += pairs * p + (SSD_TILE * p * n if ds else 0)  # du
        macs += pairs * n + (SSD_TILE * p * n if state_in else 0)  # dC
        macs += pairs * n + (SSD_TILE * p * n if ds else 0)  # dB
        macs += SSD_TILE * p * n if t > 0 else 0             # dS
    return nbytes, 2 * macs * b * h + 2 * bsn * h  # + the head sums


def bound_seconds(nbytes: float, ops: float, flops_peak: float,
                  bytes_peak: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / bytes_peak, ops / flops_peak)
