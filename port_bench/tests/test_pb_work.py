"""The yardstick's counts against counts worked by hand."""
import types

import pb_smoke  # noqa: F401  (paths)
import pytest

from port_bench import flops, peaks, work


def test_ssd_work_forward_by_hand():
    # b=h=p=n=1, s=32: one tile of 32 tokens; 528 pairs; bytes: x (2 B)
    # + dt (4) + y (4) per token, B and C (2 B each), a (4)
    nbytes, ops = work.ssd_work(1, 32, 1, 1, 1, 2, False)
    assert nbytes == 32 * 2 + 4 * 32 + 4 + 2 * 32 * 2 + 4 * 32
    assert ops == 2 * (528 * 1 + 1 * 528)


def test_ssd_work_backward_by_hand():
    nbytes, ops = work.ssd_work(1, 32, 1, 1, 1, 2, True)
    # one tile, zero state in: W and dy.u, du, dC, dB pair terms only
    assert ops == 2 * (528 * 2 + 528 + 528 + 528) + 2 * 32
    assert nbytes == (4 * 32 + 2 * 32 + 4 * 32 + 4 + 2 * 32 * 2
                      + 2 * 32 + 4 * 32 + 2 * 32 * 2)


def test_bound_and_peaks():
    assert work.bound_seconds(3.35e12, 1.0, 1e12, 3.35e12) == 1.0
    assert work.bound_seconds(1.0, 989e12, 989e12, 3.35e12) == 1.0
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    with pytest.raises(KeyError):
        peaks.peaks_for("cpu")


def _tiny():
    return types.SimpleNamespace(
        d_model=2, d_inner=4, ssm_state=1, n_ssm_heads=2, ssm_head_dim=2,
        ssm_chunk=8, d_conv=2, n_layers=2, vocab=5, n_heads=1, head_dim=2,
        d_ff=3, shared_layers=[])


def test_flops_by_hand():
    sz = _tiny()
    # projections: d (2 di + 2 n + h) + di d = 2 (8 + 2 + 2) + 8 = 32
    assert flops.mixer_weights(sz) == 32
    assert flops.conv_macs(sz) == 2 * (4 + 2)
    # 1 row of 2 tokens: 3 pairs; C.B once (n = 1), one weighted sum a
    # head (h = 2, p = 2)
    assert flops.scan_macs(sz, 1, 2) == 3 * 1 + 2 * 3 * 2
    assert flops.block_forward(sz, 1, 2) == 2 * ((32 + 12) * 2 + 15)
    assert flops.delta_macs(sz, 1) == 3 * 2 * 2
    fwd = flops.model_forward(sz, 1, 2)
    assert fwd == 2 * flops.block_forward(sz, 1, 2)
    # the probe's backward skips layer 0's block
    assert flops.probe_flops(sz, 1, 2) == fwd + flops.block_forward(sz, 1, 2)
    # a step with one unit at layer 1 (the horizon): no block above it
    units = [(1, 1)]
    d = 2 * flops.delta_macs(sz, 1) * 2
    assert flops.step_flops(sz, 1, 2, units, 1) == fwd + d + d
    assert flops.adapt_task_flops(sz, 1, 2, units, 1, 3) == \
        flops.probe_flops(sz, 1, 2) + 3 * (fwd + 2 * d)
