"""Table 3 on the port: the multi-objective criterion's ablation, L2-norm
layer selection against Fisher only, Fisher/memory, Fisher/compute and
TinyTrain; the twin of ``benchmarks/criterion_ablation.py``."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

try:
    from . import common
except ImportError:  # run as a script
    import common

from repro_torch.core.selection import select_policy

VARIANTS = (
    ("l2norm_layers", "l2norm"),
    ("fisher_only", "fisher_only"),
    ("fisher_mem", "fisher_mem"),
    ("fisher_compute", "fisher_compute"),
    ("tinytrain", "tinytrain"),
)


def run(arch: str = "tiny", episodes_per_domain: int = 2, iters: int = 12,
        meta_episodes: int = 150,
        domains: Sequence[str] = common.TARGET_DOMAINS,
        device: str = "cuda", cache_dir: Optional[str] = None):
    bb, params = common.meta_train(arch, episodes=meta_episodes,
                                   device=device, cache_dir=cache_dir)
    rows = []
    for name, crit in VARIANTS:
        if crit == "l2norm":
            # layer scores = per-unit weight L2 norms instead of Fisher: a
            # static policy from the core primitives, run as an override
            l2 = bb.weight_l2(params)
            pot = np.array([np.linalg.norm(l2[(c.layer, c.kind)])
                            for c in bb.unit_costs])
            pol = select_policy(bb.unit_costs, pot, l2, common.DEFAULT_BUDGET,
                                criterion="fisher_only")
            session = common.make_session(bb, params, 3e-3)
            accs = []
            rng = np.random.default_rng(1000)
            for dom in domains:
                for _ in range(episodes_per_domain):
                    task = common.sample_task(rng, dom)
                    a = session.adapt(task, common.DEFAULT_PROFILE,
                                      policy_override=pol, iters=iters)
                    accs.append(a.accuracy())
            rows.append({"variant": name, "avg": float(np.mean(accs))})
        else:
            r = common.run_method(bb, params, "tinytrain", criterion=crit,
                                  domains=domains,
                                  episodes_per_domain=episodes_per_domain,
                                  iters=iters)
            rows.append({"variant": name, "avg": r["avg"]})
    return rows


def main(quick: bool = True, **kw) -> List[str]:
    out = ["variant,avg_accuracy"]
    for r in run(**kw):
        out.append(f"{r['variant']},{r['avg']*100:.1f}")
    return out


if __name__ == "__main__":
    for line in main():
        print(line)
