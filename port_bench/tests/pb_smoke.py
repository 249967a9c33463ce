"""Smoke-size contexts for the benchmark's CPU tests: the port's smoke
configurations (``mamba2-smoke``, ``zamba2-smoke``) in float32 and the
adaptation mix cut to what a test run holds."""
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from port_bench import inputs  # noqa: E402

MAMBA2_SMOKE = {"name": "mamba2-smoke", "family": "ssm", "n_layers": 4,
                "d_model": 64, "vocab": 256, "ssm_state": 16,
                "ssm_expand": 2, "ssm_head_dim": 16, "ssm_chunk": 16,
                "d_conv": 4, "dtype": "float32", "subquadratic": True}
ZAMBA2_SMOKE = {"name": "zamba2-smoke", "family": "hybrid", "n_layers": 6,
                "d_model": 64, "vocab": 256, "n_heads": 4, "n_kv_heads": 4,
                "head_dim": 16, "d_ff": 128, "ssm_state": 16,
                "ssm_expand": 2, "ssm_head_dim": 16, "ssm_chunk": 16,
                "d_conv": 4, "hybrid_attn_every": 3, "dtype": "float32",
                "subquadratic": True}
ADAPT_LIMITS = {"fisher_gap": 1e-4, "select_regret": 1e-4,
                "loss_gap": 1e-3, "grad_gap": 1e-4, "change_gap": 1e-3}


def small_adapt_mix() -> dict:
    mix = inputs.load_json("traffic", "adapt.json")
    mix.update(way=3, shots=4, seq=16, pad=16, iters=3)
    mix["profile"]["scale_mem"] = 1.0
    return mix


def context(arch: dict, mix: dict, limits: dict, *, seconds: float = 1.0,
            trace: bool = False, seed: int = 2 ** 33 + 5,
            dtype: str = "float32"):
    arch = dict(arch, dtype=dtype)
    return types.SimpleNamespace(
        workload="smoke", seed=seed, seconds=seconds, trace=trace,
        sizes=inputs.Sizes(arch), mix=mix, device=torch.device("cpu"),
        t0=time.perf_counter(), limits=dict(limits))


class one_thread:
    """Tiny ops on many threads under several test workers run far slower."""

    def __enter__(self):
        self.before = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.before)
