"""Fig. 3 on the port: per-layer contribution, the accuracy gain from
updating each single layer and the gain per parameter and per MAC (the
observation behind the multi-objective criterion); the twin of
``benchmarks/layer_analysis.py``."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

try:
    from . import common
except ImportError:  # run as a script
    import common

from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy


def run(arch: str = "tiny", iters: int = 10, domain: str = "stripes",
        channel_ratio: float = 0.5, max_layers: int = 0,
        meta_episodes: int = 150, device: str = "cuda",
        cache_dir: Optional[str] = None):
    bb, params = common.meta_train(arch, episodes=meta_episodes,
                                   device=device, cache_dir=cache_dir)
    task = common.sample_task(np.random.default_rng(7), domain)
    session = common.make_session(bb, params, 1e-3)
    base = session.evaluate(task)
    rows = []
    layers = bb.unit_costs if not max_layers else bb.unit_costs[-max_layers:]
    for c in layers:
        k = max(1, int(c.n_channels * channel_ratio))
        pol = SparseUpdatePolicy(
            horizon=c.layer,
            units=(SelectedUnit(c.layer, c.kind, tuple(range(k))),))
        a = session.adapt(task, common.DEFAULT_PROFILE, policy_override=pol,
                          iters=iters)
        gain = a.accuracy() - base
        rows.append({
            "layer": c.layer, "kind": c.kind, "gain_pp": gain * 100,
            "gain_per_kparam": gain * 100 / (c.n_params / 1e3),
            "gain_per_mmac": gain * 100 / (c.macs / 1e6),
            "block": bb.cfg.layers[c.layer].block,
        })
    return base, rows


def main(quick: bool = True, **kw) -> List[str]:
    kw.setdefault("max_layers", 8 if quick else 0)
    kw.pop("domains", None)
    kw.pop("episodes_per_domain", None)
    base, rows = run(**kw)
    out = [f"# base accuracy {base*100:.1f}",
           "layer,block,kind,gain_pp,gain_per_kparam,gain_per_mmac"]
    for r in rows:
        out.append(f"{r['layer']},{r['block']},{r['kind']},{r['gain_pp']:.1f},"
                   f"{r['gain_per_kparam']:.2f},{r['gain_per_mmac']:.2f}")
    return out


if __name__ == "__main__":
    for line in main():
        print(line)
