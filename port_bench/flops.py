"""The benchmark's own count of model FLOPs (two per multiply-add), from
the configuration's shapes, the work's rows and tokens and the policy the
program reports.  Imports nothing of the port.

Conventions, fixed here so that the count never follows the program:
the forward is counted over every row; a block's data gradient costs its
forward again; the fine-tune's backward runs down to the policy's
deepest (lowest) selected layer, with weight gradients for the selected
heads' deltas only; the probe's backward runs to its lowest tap (layer
0's mixer output); nothing is counted for recomputation.  The SSD is
counted as its quadratic in-chunk form (C.B once a pair, shared by the
heads; one weighted sum a head) on a zero state.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def mixer_weights(sz) -> int:
    """Multiply-adds of one SSD block's projections a token."""
    d, di, n, h = sz.d_model, sz.d_inner, sz.ssm_state, sz.n_ssm_heads
    return d * (2 * di + 2 * n + h) + di * d


def conv_macs(sz) -> int:
    return sz.d_conv * (sz.d_inner + 2 * sz.ssm_state)


def shared_weights(sz) -> int:
    """Multiply-adds of the shared block's projections and MLP a token."""
    if not sz.shared_layers:
        return 0
    q = sz.n_heads * sz.head_dim
    return 4 * sz.d_model * q + 3 * sz.d_model * sz.d_ff


def scan_macs(sz, rows: int, seq: int) -> int:
    """The SSD's in-chunk pairs over ``rows`` sequences of ``seq`` tokens
    (one chunk while seq <= ssm_chunk; longer sequences add the state)."""
    q = min(seq, sz.ssm_chunk)
    pairs = q * (q + 1) // 2
    chunks = -(-seq // q)
    per_chunk = pairs * sz.ssm_state + sz.n_ssm_heads * pairs * sz.ssm_head_dim
    state = (chunks - 1) * 2 * q * sz.n_ssm_heads * sz.ssm_head_dim \
        * sz.ssm_state
    return rows * (chunks * per_chunk + state)


def block_forward(sz, rows: int, seq: int) -> int:
    """FLOPs of one SSD layer over rows x seq tokens, cache-free."""
    t = rows * seq
    return 2 * ((mixer_weights(sz) + conv_macs(sz)) * t
                + scan_macs(sz, rows, seq))


def shared_forward(sz, rows: int, seq: int) -> int:
    """FLOPs of one shared-block application, causal, cache-free."""
    if not sz.shared_layers:
        return 0
    attn = 2 * sz.n_heads * sz.head_dim * rows * seq * (seq + 1) // 2
    return 2 * (shared_weights(sz) * rows * seq + attn)


def delta_macs(sz, n_heads: int) -> int:
    """Multiply-adds a token of one unit's head deltas (w_z, w_x, w_out)."""
    return 3 * sz.d_model * n_heads * sz.ssm_head_dim


def model_forward(sz, rows: int, seq: int,
                  units: Sequence[Tuple[int, int]] = ()) -> int:
    shared = len(sz.shared_layers)
    delta = sum(2 * delta_macs(sz, k) * rows * seq for _, k in units)
    return (sz.n_layers * block_forward(sz, rows, seq)
            + shared * shared_forward(sz, rows, seq) + delta)


def probe_flops(sz, rows: int, seq: int) -> int:
    """Forward over every row, then data gradients down to layer 0's tap."""
    back = ((sz.n_layers - 1) * block_forward(sz, rows, seq)
            + len(sz.shared_layers) * shared_forward(sz, rows, seq))
    return model_forward(sz, rows, seq) + back


def step_flops(sz, rows: int, seq: int, units: Sequence[Tuple[int, int]],
               horizon: int) -> int:
    """One fine-tune step: the forward with the deltas, data gradients
    through the layers above the horizon and the shared blocks after the
    horizon layer, weight gradients of the deltas."""
    t = rows * seq
    above = sum(1 for j in range(sz.n_layers) if j > horizon)
    shared = sum(1 for j in sz.shared_layers if j >= horizon)
    back = (above * block_forward(sz, rows, seq)
            + shared * shared_forward(sz, rows, seq)
            + sum(2 * delta_macs(sz, k) * t for _, k in units))
    return model_forward(sz, rows, seq, units) + back


def adapt_task_flops(sz, rows: int, seq: int,
                     units: Sequence[Tuple[int, int]], horizon: int,
                     iters: int) -> int:
    """One adaptation: the probe and ``iters`` fine-tune steps; ``rows``
    counts the support and pseudo-query rows together."""
    return (probe_flops(sz, rows, seq)
            + iters * step_flops(sz, rows, seq, units, horizon))
