"""Tables 9/10 on the port: the latency breakdown, Fisher probe against
sparse fine-tune (TinyTrain) against SparseUpdate's run time, measured on
the device the session runs on; the twin of
``benchmarks/latency_breakdown.py``."""
from __future__ import annotations

from typing import List, Optional, Sequence

try:
    from . import common
except ImportError:  # run as a script
    import common


def run(arch: str = "tiny", episodes_per_domain: int = 1, iters: int = 12,
        meta_episodes: int = 150,
        domains: Sequence[str] = common.TARGET_DOMAINS,
        device: str = "cuda", cache_dir: Optional[str] = None):
    bb, params = common.meta_train(arch, episodes=meta_episodes,
                                   device=device, cache_dir=cache_dir)
    rows = []
    for m in ("sparseupdate", "tinytrain"):
        # a warm-up episode first on a shared session: steady-state latency
        # (first calls of a shape are one-offs, as the paper's warmed runtime)
        session = common.make_session(bb, params, 3e-3)
        common.run_method(bb, params, m, domains=domains[:1],
                          episodes_per_domain=1, iters=iters,
                          session=session)
        r = common.run_method(bb, params, m, domains=domains,
                              episodes_per_domain=episodes_per_domain,
                              iters=iters, session=session)
        total = r["fisher_s"] + r["train_s"]
        rows.append({
            "method": m, "fisher_s": r["fisher_s"], "train_s": r["train_s"],
            "total_s": total,
            "fisher_pct": 100 * r["fisher_s"] / total if total else 0.0,
            "steps_per_sec": r["steps_per_sec"],
            "host_transfers": r["host_transfers"],
        })
    return rows


def main(quick: bool = True, **kw) -> List[str]:
    out = ["method,fisher_s,train_s,total_s,fisher_pct,steps_per_sec,"
           "host_transfers"]
    for r in run(**kw):
        out.append(f"{r['method']},{r['fisher_s']:.4f},{r['train_s']:.4f},"
                   f"{r['total_s']:.4f},{r['fisher_pct']:.1f},"
                   f"{r['steps_per_sec']:.1f},{r['host_transfers']:.0f}")
    return out


if __name__ == "__main__":
    for line in main():
        print(line)
