"""The port's op-level cost analyser (``launch/op_analysis.py``) against the
JAX package's trip-count-aware HLO analyser (``launch/hlo_analysis.py``).

The five programs of ``tests/test_hlo_analysis.py`` (a matmul, a loop of
10 products, loops nested 5 x 10, a tanh loop of 7, a chain of five
products three times), each with its exact FLOPs, on the CPU and on the
meta device, equal to ``analyse_hlo`` of the JAX twin; then what writes
bytes, the lifetimes behind ``peak_live_bytes`` and the meta device's
rebuilt results.  The dry run's model steps are held against the JAX
analyser in ``test_torch_op_analysis_steps.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.launch.hlo_analysis import analyse_hlo
from repro_torch.launch.op_analysis import analyse_ops


def hlo(f, *specs):
    return analyse_hlo(jax.jit(f).lower(*specs).compile().as_text())


def f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


# -- the analyser programs ---------------------------------------------------


def t_matmul(a, b):
    return a @ b


def j_matmul(a, b):
    return a @ b


def t_loop(x, w):
    for _ in range(10):
        x = x @ w
    return x.sum()


def j_loop(x, w):
    y, _ = lax.scan(lambda c, _: (c @ w, None), x, None, length=10)
    return jnp.sum(y)


def t_nested(x, w):
    for _ in range(5):
        for _ in range(10):
            x = x @ w
    return x.sum()


def j_nested(x, w):
    def outer(c, _):
        y, _ = lax.scan(lambda c, _: (c @ w, None), c, None, length=10)
        return y, None

    y, _ = lax.scan(outer, x, None, length=5)
    return jnp.sum(y)


def t_tanh(x, w):
    for _ in range(7):
        x = torch.tanh(x @ w)
    return x


def j_tanh(x, w):
    y, _ = lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None, length=7)
    return y


def t_chain(a, b, c, d, e, x):
    for _ in range(3):
        x = x @ a @ b @ c @ d @ e
    return x.sum()


def j_chain(a, b, c, d, e, x):
    y, _ = lax.scan(lambda x, _: (x @ a @ b @ c @ d @ e, None), x, None,
                    length=3)
    return jnp.sum(y)


PROGRAMS = {
    "matmul": (t_matmul, j_matmul, [(64, 128), (128, 32)], 2 * 64 * 128 * 32),
    "loop": (t_loop, j_loop, [(64, 128), (128, 128)],
             10 * 2 * 64 * 128 * 128),
    "nested": (t_nested, j_nested, [(64, 128), (128, 128)],
               50 * 2 * 64 * 128 * 128),
    "tanh": (t_tanh, j_tanh, [(32, 64), (64, 64)], 7 * 2 * 32 * 64 * 64),
    "chain": (t_chain, j_chain, [(16, 16)] * 6, 3 * 5 * 2 * 16 ** 3),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_programs_count_exact_flops_equal_to_the_hlo_analyser(name, device):
    tf, jf, shapes, want = PROGRAMS[name]
    args = [torch.randn(s) if device == "cpu" else torch.empty(s,
                                                               device="meta")
            for s in shapes]
    got = analyse_ops(tf, *args)
    assert got["flops"] == want
    assert got["flops"] == pytest.approx(hlo(jf, *map(lambda s: f32(*s),
                                                      shapes))["flops"],
                                         rel=1e-6)
    assert got["collective_bytes"] is None and got["collectives"] == {}
    assert sum(r["flops"] for r in got["ops"].values()) == want
    if name == "tanh":
        assert 0 < got["bytes_floor"] <= got["bytes"]
        assert got["ops"]["tanh"]["count"] == 7
        assert got["ops"]["tanh"]["bytes"] == 7 * 32 * 64 * 4


# -- lifetimes ---------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_live_bytes_follows_storage_lifetimes(device):
    n = 1000

    def chain(x):
        a = x + 1
        b = a + 1
        del a
        c = b + 1
        del b
        return c

    x = torch.empty(n, device=device)
    got = analyse_ops(chain, x)
    assert got["peak_live_bytes"] == 2 * 4 * n  # never three at once
    assert got["bytes"] == 3 * 4 * n
    assert got["bytes_floor"] == 2 * 4 * n

    def saved(x):
        # exp saves its result for the backward: both stay alive with the
        # graph the loss holds, though the names are gone
        y = x.exp()
        return y.exp().sum()

    got = analyse_ops(saved, x.requires_grad_())
    assert got["peak_live_bytes"] == 2 * 4 * n + 4
    assert got["ops"]["detach"]["bytes"] == 0  # an alias writes nothing


def test_views_and_in_place_ops_write_nothing():
    x = torch.empty((8, 16), device="meta")

    def f(x):
        y = x.t().contiguous()  # a copy: one result of 512 B
        y.mul_(2)
        return y[1:].view(-1)

    got = analyse_ops(f, x)
    assert got["bytes"] == 8 * 16 * 4
    assert set(got["ops"]) >= {"mul_", "slice", "view"}
    assert all(got["ops"][k]["bytes"] == 0 for k in ("mul_", "slice",
                                                     "view"))


def test_meta_results_repeat_the_ops_own():
    """A repeated op on the meta device is rebuilt from its first call's
    results: the same shapes, strides and dtypes as the op's own."""
    x = torch.empty((4, 6), device="meta").t()

    def f(x):
        return [torch.nn.functional.softmax(x, dim=0) for _ in range(3)] + [
            x.contiguous(), x.float().sum(0, dtype=torch.float64)]

    want = f(x)
    got = []
    analyse_ops(lambda x: got.extend(f(x)) or got, x)
    assert [(g.shape, g.stride(), g.dtype) for g in got] == [
        (w.shape, w.stride(), w.dtype) for w in want]
    assert np.prod(got[0].shape) == 24
