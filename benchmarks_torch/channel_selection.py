"""Fig. 4 / 6b on the port: dynamic (Fisher) against static (random,
L2-norm) channel selection at equal layer selection and budget; the twin
of ``benchmarks/channel_selection.py``."""
from __future__ import annotations

from typing import List, Optional, Sequence

try:
    from . import common
except ImportError:  # run as a script
    import common

MODES = ("dynamic", "random", "l2norm")


def run(arch: str = "tiny", episodes_per_domain: int = 2, iters: int = 12,
        meta_episodes: int = 150,
        domains: Sequence[str] = common.TARGET_DOMAINS,
        device: str = "cuda", cache_dir: Optional[str] = None):
    bb, params = common.meta_train(arch, episodes=meta_episodes,
                                   device=device, cache_dir=cache_dir)
    rows = []
    for mode in MODES:
        r = common.run_method(bb, params, "tinytrain", channel_mode=mode,
                              domains=domains,
                              episodes_per_domain=episodes_per_domain,
                              iters=iters)
        rows.append({"mode": mode, "avg": r["avg"],
                     "per_domain": r["per_domain"]})
    return rows


def main(quick: bool = True, **kw) -> List[str]:
    rows = run(**kw)
    doms = list(rows[0]["per_domain"])
    out = ["channel_mode," + ",".join(doms) + ",avg"]
    for r in rows:
        accs = ",".join(f"{r['per_domain'][d]*100:.1f}" for d in doms)
        out.append(f"{r['mode']},{accs},{r['avg']*100:.1f}")
    return out


if __name__ == "__main__":
    for line in main():
        print(line)
