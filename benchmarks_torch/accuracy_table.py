"""Table 1 on the port: top-1 accuracy of TinyTrain against the baselines
across cross-domain targets (synthetic episodes); the twin of
``benchmarks/accuracy_table.py``."""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

try:
    from . import common
except ImportError:  # run as a script
    import common

METHODS = ("none", "fulltrain", "lastlayer", "tinytl", "sparseupdate",
           "tinytrain")


def run(arch: str = "tiny", episodes_per_domain: int = 2, iters: int = 12,
        meta_episodes: int = 150, methods=METHODS,
        domains: Sequence[str] = common.TARGET_DOMAINS,
        device: str = "cuda", cache_dir: Optional[str] = None
        ) -> List[Dict]:
    bb, params = common.meta_train(arch, episodes=meta_episodes,
                                   device=device, cache_dir=cache_dir)
    rows = []
    for m in methods:
        t0 = time.perf_counter()
        r = common.run_method(bb, params, m, domains=domains,
                              episodes_per_domain=episodes_per_domain,
                              iters=iters)
        r["wall_s"] = time.perf_counter() - t0
        r["arch"] = arch
        rows.append(r)
    return rows


def main(quick: bool = True, **kw) -> List[str]:
    rows = run(**kw)
    doms = list(rows[0]["per_domain"])
    out = ["arch,method," + ",".join(doms) + ",avg,train_s"]
    for r in rows:
        accs = ",".join(f"{r['per_domain'][d]*100:.1f}" for d in doms)
        out.append(f"{r['arch']},{r['method']},{accs},{r['avg']*100:.1f},"
                   f"{r['train_s']:.4f}")
    return out


if __name__ == "__main__":
    for line in main():
        print(line)
