"""The SSD scan kernels' ``torch.func`` rules on the CPU: ``SSDScanFn`` and
``SSDScanBwdFn`` under ``torch.func.vmap`` of ``torch.func.grad_and_value``,
the route ``adapt_many`` takes for the ssm and hybrid families on a card.

The kernels cannot run here, so a seam replaces their two launch entries
(``ssd_scan.ssd_scan_fwd_cuda`` and ``ssd_scan.ssd_scan_bwd_cuda``) with
the plain ``ssd_scan_ref`` and its autograd backward, and ``ops._on_card``
sends CPU tensors down the card path.  What is held: the ``vmap`` rules
fold the task axis into the batch and launch once each way for all
tasks; each task's y, final state, dx, d(dt), dB and dC equal a Python
loop of one-task calls bit for bit; a batched ``a`` or ``init_state``
raises, and so do a gradient of either and a double backward; and
``adapt_many`` of mamba2-smoke and zamba2-smoke down the kernels' route
launches the scan as often for three tasks as for one."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ssd_scan
from repro_torch.kernels.ref import ssd_scan_ref

T_TASKS, B, S, H, P, N, Q = 3, 2, 16, 4, 8, 8, 8


def _fwd_plain(x, dt, a, bmat, cmat, *, chunk, init_state=None,
               want_state=False):
    y, st = ssd_scan_ref(x.float(), dt, a, bmat, cmat, init_state)
    return y, st if want_state else None


def _bwd_plain(dy, x, dt, a, bmat, cmat, *, chunk, init_state=None):
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_()
                  for t in (x, dt, bmat, cmat)]
        y, _ = ssd_scan_ref(leaves[0], leaves[1], a, leaves[2], leaves[3],
                            init_state)
        return torch.autograd.grad(y, leaves, dy)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def seam(monkeypatch):
    """The kernels' entries at their plain versions, CPU tensors routed
    down the card path, the launch counters at 0."""
    monkeypatch.setattr(ssd_scan, "ssd_scan_fwd_cuda", _fwd_plain)
    monkeypatch.setattr(ssd_scan, "ssd_scan_bwd_cuda", _bwd_plain)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops.ssd_scan, "launches", 0)
    monkeypatch.setattr(ops.ssd_scan, "bwd_launches", 0)


def _inputs(seed=0, tasks=T_TASKS):
    rng = np.random.default_rng(seed)

    def f(*shape, lo=None):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(np.abs(a) * 0.1 if lo else a)

    return dict(x=f(tasks, B, S, H, P), dt=f(tasks, B, S, H, lo=True),
                a=-torch.linspace(0.5, 2.0, H), b=f(tasks, B, S, N),
                c=f(tasks, B, S, N), w=f(tasks, B, S, H, P),
                init=f(B, H, P, N))


def _loss(a, init=None):
    def f(x, dt, bmat, cmat, w):
        y, _ = ops.ssd_scan(x, dt, a, bmat, cmat, chunk=Q, init_state=init,
                            want_state=False, out_dtype=torch.float32)
        return (y * w).sum()

    return torch.func.grad_and_value(f, argnums=(0, 1, 2, 3))


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_vmapped_grad_equals_per_task_loop_bit_for_bit(seam, with_init):
    d = _inputs()
    init = d["init"] if with_init else None
    args = (d["x"], d["dt"], d["b"], d["c"], d["w"])
    grads, loss = torch.func.vmap(_loss(d["a"], init))(*args)
    assert (ops.ssd_scan.launches, ops.ssd_scan.bwd_launches) == (1, 1)
    for k in range(T_TASKS):
        g_k, l_k = _loss(d["a"], init)(*(t[k] for t in args))
        assert torch.equal(loss[k], l_k)
        for name, got, want in zip(("dx", "d(dt)", "dB", "dC"), grads, g_k):
            assert got[k].dtype == want.dtype
            assert torch.equal(got[k], want), (name, k)
    assert (ops.ssd_scan.launches, ops.ssd_scan.bwd_launches) == (
        1 + T_TASKS, 1 + T_TASKS)


def test_vmapped_forward_unfolds_y_and_the_final_state(seam):
    d = _inputs(1)

    def fwd(x, dt, bmat, cmat):
        return ops.ssd_scan(x, dt, d["a"], bmat, cmat, chunk=Q,
                            init_state=d["init"], out_dtype=torch.float32)

    y, st = torch.func.vmap(fwd)(d["x"], d["dt"], d["b"], d["c"])
    assert ops.ssd_scan.launches == 1 and ops.ssd_scan.bwd_launches == 0
    assert y.shape == (T_TASKS, B, S, H, P) and st.shape == (T_TASKS, B, H,
                                                             P, N)
    for k in range(T_TASKS):
        y_k, st_k = fwd(d["x"][k], d["dt"][k], d["b"][k], d["c"][k])
        assert torch.equal(y[k], y_k) and torch.equal(st[k], st_k)
    # an operand shared by every task (B and C here) is repeated for each
    y2, _ = torch.func.vmap(fwd, in_dims=(0, 0, None, None))(
        d["x"], d["dt"], d["b"][0], d["c"][0])
    for k in range(T_TASKS):
        assert torch.equal(y2[k], fwd(d["x"][k], d["dt"][k], d["b"][0],
                                      d["c"][0])[0])


@pytest.mark.parametrize("what", ["a", "init_state"])
def test_a_batched_a_or_init_state_raises(seam, what):
    d = _inputs(2)
    a = d["a"].expand(T_TASKS, H)
    init = d["init"].expand(T_TASKS, *d["init"].shape)

    def fwd(x, av, iv):
        return ops.ssd_scan(x, d["dt"][0], av, d["b"][0], d["c"][0], chunk=Q,
                            init_state=iv)[0]

    dims = (0, 0, None) if what == "a" else (0, None, 0)
    with pytest.raises(NotImplementedError, match=f"{what} must be the same"):
        torch.func.vmap(fwd, in_dims=dims)(d["x"], a if what == "a"
                                           else d["a"], init)
    assert ops.ssd_scan.launches == 0


@pytest.mark.parametrize("what", ["a", "init_state"])
def test_a_gradient_of_a_or_init_state_raises(seam, what):
    d = _inputs(3)
    a = d["a"].clone().requires_grad_(what == "a")
    init = d["init"].clone().requires_grad_(what == "init_state")
    with pytest.raises(NotImplementedError, match="no gradient"):
        ops.ssd_scan(d["x"][0], d["dt"][0], a, d["b"][0], d["c"][0], chunk=Q,
                     init_state=init)


def test_a_double_backward_raises(seam):
    d = _inputs(4)
    x = d["x"][0].clone().requires_grad_()
    y, _ = ops.ssd_scan(x, d["dt"][0], d["a"], d["b"][0], d["c"][0], chunk=Q,
                        want_state=False, out_dtype=torch.float32)
    (gx,) = torch.autograd.grad((y * d["w"][0]).sum(), x, create_graph=True)
    assert ops.ssd_scan.bwd_launches == 1
    with pytest.raises(NotImplementedError, match="double backward"):
        torch.autograd.grad(gx.sum(), x)


@pytest.fixture
def card_route(seam, monkeypatch):
    """``ssm.ssd_chunked`` down its card branch (``ops.ssd_scan`` through
    :class:`SSDScanFn`) for CPU tensors too."""
    from repro_torch.models import ssm

    def chunked(x, dt, a, bmat, cmat, chunk, init_state=None, *,
                need_state=True):
        y, fin = ops.ssd_scan(x, dt, a, bmat, cmat, chunk=chunk,
                              init_state=init_state, want_state=need_state,
                              out_dtype=torch.promote_types(x.dtype,
                                                            dt.dtype))
        return y, None if fin is None else fin.to(
            x.dtype if init_state is None else init_state.dtype)

    monkeypatch.setattr(ssm, "ssd_chunked", chunked)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_adapt_many_runs_the_kernel_route_once_for_all_tasks(card_route,
                                                              arch):
    """``adapt_many`` of an ssm or hybrid backbone down the kernels' route
    (their entries at the plain versions): the fleet's fine-tune launches
    the scan as many times for three tasks as for one, and each task's
    losses and deltas equal its own one-task fleet's."""
    from repro_torch import api, configs
    from repro_torch.core.backbones import lm_backbone
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy

    cfg = configs.get_reduced(arch)
    bb = lm_backbone(cfg, tokens_per_batch=16 * 16, batch_size=16)
    session = api.TinyTrainSession(bb, max_way=4, device="cpu")
    policy = SparseUpdatePolicy(horizon=1, units=(
        SelectedUnit(1, "ssm", (0, 5)), SelectedUnit(cfg.n_layers - 1,
                                                     "ssm", (2,))))
    tasks = [api.sample_lm_task(np.random.default_rng(s), cfg.vocab, seq=16,
                                max_way=4, support_pad=16, query_pad=16)
             for s in range(3)]
    many = session.adapt_many(tasks, api.JETSON_NANO, iters=2,
                              policy_override=policy)
    counts = (ops.ssd_scan.launches, ops.ssd_scan.bwd_launches)
    assert counts[0] > 0 and counts[1] > 0
    for task, m in zip(tasks, many):
        ops.ssd_scan.launches = ops.ssd_scan.bwd_launches = 0
        (one,) = session.adapt_many([task], api.JETSON_NANO, iters=2,
                                    policy_override=policy)
        assert (ops.ssd_scan.launches, ops.ssd_scan.bwd_launches) == counts
        np.testing.assert_allclose(m.losses, one.losses, rtol=1e-5,
                                   atol=1e-6)
        for name, d in m.deltas[f"L{cfg.n_layers - 1}"]["ssm"].items():
            np.testing.assert_allclose(
                d.numpy(), one.deltas[f"L{cfg.n_layers - 1}"]["ssm"][name]
                .numpy(), rtol=1e-4, atol=1e-6)
