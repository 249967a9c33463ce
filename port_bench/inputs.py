"""What the benchmark hands the program and the reference alike: the
configuration's sizes and weights made on the device from the seed.
Imports nothing of the port: the tree is laid out as
the port's ``init_params`` lays it out (one stack group of SSD layers,
zamba2's ``shared_attn`` block), and a CPU test holds the two layouts
equal."""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(*parts: str) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


class Sizes:
    """The configuration's numbers (the ``arch`` object of its file), with
    the derived widths the port derives the same way."""

    def __init__(self, arch: Dict[str, Any]):
        self.arch = dict(arch)
        for k, v in arch.items():
            if k != "dtype":
                setattr(self, k, v)
        self.ssm_expand = arch.get("ssm_expand", 2)
        self.n_heads = arch.get("n_heads", 0)
        self.head_dim = arch.get("head_dim", 0)
        self.d_ff = arch.get("d_ff", 0)
        self.hybrid_attn_every = arch.get("hybrid_attn_every", 0)
        self.rope_theta = arch.get("rope_theta", 10000.0)
        self.d_conv = arch.get("d_conv", 4)
        self.d_inner = self.ssm_expand * self.d_model
        self.n_ssm_heads = self.d_inner // self.ssm_head_dim
        if arch["family"] not in ("ssm", "hybrid"):
            raise ValueError(f"family {arch['family']!r}: the benchmark's "
                             "weights and reference cover ssm and hybrid")

    @property
    def shared_layers(self):
        """Layers after which the shared block runs (hybrid only)."""
        e = self.hybrid_attn_every
        return [i for i in range(self.n_layers) if e and (i + 1) % e == 0]

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.arch.get("dtype", "bfloat16"))


def make_weights(sz: Sizes, seed: int, device) -> Dict[str, Any]:
    """Random weights from ``seed`` on ``device``, one generator call a
    stacked leaf, in the configuration's dtype: projections uniform in
    ±1/sqrt(d_in), the embedding N(0, 0.02²), conv taps N(0, 0.1²), norm
    gains (scale 1 + w) small and random so that every term of the
    reference is exercised, and Mamba2's own dt initialisation (step
    sizes log-uniform in [1e-3, 1e-1] through the inverse softplus), so
    the state carries tens to thousands of tokens, as a trained model's
    does."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    dt = sz.torch_dtype
    L, d, di, n, h = (sz.n_layers, sz.d_model, sz.d_inner, sz.ssm_state,
                      sz.n_ssm_heads)

    def uniform(*shape):
        s = 1.0 / math.sqrt(shape[-2])
        u = torch.rand(shape, generator=gen, device=device)
        return u.mul_(2 * s).sub_(s).to(dt)

    def normal(std, *shape):
        return torch.randn(shape, generator=gen, device=device).mul_(
            std).to(dt)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=device))
    ssm = {"w_z": uniform(L, d, di), "w_x": uniform(L, d, di),
           "w_b": uniform(L, d, n), "w_c": uniform(L, d, n),
           "w_dt": uniform(L, d, h),
           "dt_bias": _dt_bias(gen, L, h, device).to(dt),
           "a_log": a_log.to(dt).expand(L, h).clone(),
           "d_skip": (1.0 + normal(0.1, L, h).float()).to(dt),
           "conv_w": normal(0.1, L, sz.d_conv, di + 2 * n),
           "norm_w": normal(0.1, L, di),
           "w_out": uniform(L, di, d)}
    p = {"embed": normal(0.02, sz.vocab, d),
         "stacks": {"g0": {"norm1": {"w": normal(0.1, L, d)}, "ssm": ssm}},
         "final_norm": {"w": normal(0.1, d)}}
    if sz.shared_layers:
        q = sz.n_heads * sz.head_dim
        p["shared_attn"] = {
            "norm1": {"w": normal(0.1, d)},
            "attn": {"wq": uniform(d, q), "wk": uniform(d, q),
                     "wv": uniform(d, q), "wo": uniform(q, d)},
            "norm2": {"w": normal(0.1, d)},
            "mlp": {"w_gate": uniform(d, sz.d_ff), "w_up": uniform(d, sz.d_ff),
                    "w_down": uniform(sz.d_ff, d)}}
    return p


def _dt_bias(gen, n_layers: int, n_heads: int, device) -> torch.Tensor:
    """softplus^-1 of step sizes log-uniform in [1e-3, 1e-1]."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((n_layers, n_heads), generator=gen, device=device)
    dt = torch.exp(u * (hi - lo) + lo)
    return dt + torch.log(-torch.expm1(-dt))
