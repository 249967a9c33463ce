"""Fig. 6a on the port: accuracy with and without offline meta-training,
per on-device method; the twin of ``benchmarks/meta_training_effect.py``."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

try:
    from . import common
except ImportError:  # run as a script
    import common

METHODS = ("none", "lastlayer", "tinytrain")


def run(arch: str = "tiny", episodes_per_domain: int = 2, iters: int = 12,
        meta_episodes: int = 150,
        domains: Sequence[str] = common.TARGET_DOMAINS,
        device: str = "cuda", cache_dir: Optional[str] = None):
    bb, params_meta = common.meta_train(arch, episodes=meta_episodes,
                                        device=device, cache_dir=cache_dir)
    dev = common.resolve_device(device)
    # the seed's init, before meta-training: the pre-trained-only stand-in
    params_raw = bb.init(torch.Generator(device=dev).manual_seed(0))
    rows = []
    for m in METHODS:
        r0, r1 = (common.run_method(bb, p, m, domains=domains,
                                    episodes_per_domain=episodes_per_domain,
                                    iters=iters)
                  for p in (params_raw, params_meta))
        rows.append({"method": m, "no_meta": r0["avg"], "meta": r1["avg"]})
    return rows


def main(quick: bool = True, **kw) -> List[str]:
    out = ["method,no_meta_acc,meta_acc,gain_pp"]
    for r in run(**kw):
        out.append(f"{r['method']},{r['no_meta']*100:.1f},"
                   f"{r['meta']*100:.1f},{(r['meta']-r['no_meta'])*100:.1f}")
    return out


if __name__ == "__main__":
    for line in main():
        print(line)
