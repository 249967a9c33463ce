"""Table 2 on the port: backward-pass memory and MACs per method, from the
Appendix-A.4 cost model, exact, per paper CNN backbone (the twin of
``benchmarks/memory_compute_table.py``; pure arithmetic, no device).

Methods: FullTrain / LastLayer / TinyTL / SparseUpdate / TinyTrain, batch 1
(batch 100 for FullTrain and TinyTL, as in the paper)."""
from __future__ import annotations

import os
import sys
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.backbones import cnn_backbone  # noqa: E402
from repro_torch.core.criterion import (  # noqa: E402
    delta_params_of, full_backward_macs, policy_backward_macs,
)
from repro_torch.models.edge_cnn import (  # noqa: E402
    EDGE_CNNS, cnn_layer_costs,
)

PARAM_BYTES = 4
ADAM_SLOTS = 2


def method_costs(arch: str, in_res: int = 84) -> List[Dict]:
    cfg = EDGE_CNNS[arch](in_res=in_res)
    costs = cnn_backbone(cfg, batch_size=1).unit_costs
    lc = cnn_layer_costs(cfg)
    total_params = sum(c.n_params for c in costs)
    full_bwd = full_backward_macs(costs)
    act_all = sum(c["act"] for c in lc) * 4  # all activations saved

    def mem(updated_params, act_bytes, batch=1):
        w = updated_params * PARAM_BYTES
        return w + w * ADAM_SLOTS + act_bytes * batch

    def selected(frac_layers: float, div: int):
        h = int(cfg.n_layers * frac_layers)
        sel = {(c.layer, c.kind): max(1, c.n_channels // div)
               for c in costs if c.layer >= h}
        params = sum(delta_params_of(c, sel[(c.layer, c.kind)])
                     for c in costs if (c.layer, c.kind) in sel)
        act = sum(c.act_in_bytes for c in costs if (c.layer, c.kind) in sel)
        return mem(params, act), policy_backward_macs(costs, sel, h)

    last = costs[-1]
    sp_mem, sp_macs = selected(0.55, 2)   # static, MCUNetV3-like
    tt_mem, tt_macs = selected(0.8, 4)    # budgeted: last ~25 %, 25 %
    rows = [
        # FullTrain: all params, all activations, batch 100 (paper setup)
        {"method": "FullTrain",
         "mem_bytes": mem(total_params, act_all, batch=100),
         "macs": full_bwd},
        {"method": "LastLayer",
         "mem_bytes": mem(last.n_params, last.act_in_bytes),
         "macs": last.dx_macs + last.macs},
        # TinyTL: adapters ~= 15 % of params, residual activations
        {"method": "TinyTL",
         "mem_bytes": mem(int(0.15 * total_params), act_all // 2, batch=100),
         "macs": int(full_bwd * 0.5)},
        {"method": "SparseUpdate", "mem_bytes": sp_mem, "macs": sp_macs},
        {"method": "TinyTrain", "mem_bytes": tt_mem, "macs": tt_macs},
    ]
    for r in rows:
        r["arch"] = arch
        r["mem_ratio"] = r["mem_bytes"] / tt_mem
        r["mac_ratio"] = r["macs"] / tt_macs
    return rows


def main(quick: bool = True, **_) -> List[str]:
    out = ["arch,method,mem_MB,mem_ratio,backward_MACs_M,mac_ratio"]
    for arch in EDGE_CNNS:
        for r in method_costs(arch):
            out.append(
                f"{r['arch']},{r['method']},{r['mem_bytes']/1e6:.2f},"
                f"{r['mem_ratio']:.1f},{r['macs']/1e6:.2f},{r['mac_ratio']:.2f}")
    return out


if __name__ == "__main__":
    for line in main():
        print(line)
