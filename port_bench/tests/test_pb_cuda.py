"""The adaptation driver on the card at smoke size: the port's kernels
(the SSD scan and its backward, the Fisher reduction, the aligned flash
attention of the hybrid's shared block) against the float32 reference.
Run on a machine with a card:

    python -m pytest -q -m cuda port_bench/tests/test_pb_cuda.py
"""
import pytest
import torch
import pb_smoke
from pb_smoke import MAMBA2_SMOKE, ZAMBA2_SMOKE

from port_bench.drivers import adapt as DA

# the kernels compute the scan in float32 with TF32 splits: within 1e-4
# of the plain version, so gaps of the float32 program stay below these
CARD_ADAPT = {"fisher_gap": 1e-2, "select_regret": 1e-2, "loss_gap": 1e-2,
              "grad_gap": 1e-2, "change_gap": 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _on(ctx, dev):
    ctx.device = dev
    return ctx


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [MAMBA2_SMOKE, ZAMBA2_SMOKE],
                         ids=lambda a: a["name"])
def test_card_adapt_smoke(card, arch):
    ctx = _on(pb_smoke.context(arch, pb_smoke.small_adapt_mix(), CARD_ADAPT,
                               trace=True), card)
    rec = DA.run(ctx)
    for k, c in rec["checks"].items():
        assert c["value"] <= c["limit"], (k, c)
    assert rec["peak_bytes"] > 0 and rec["trace"]["busy_s"] > 0
    assert rec["trace"]["launches"] > 0
