"""The port's Mamba2 SSD scan against the JAX package's: the plain version
behind ``ops.ssd_scan`` against ``repro.kernels.ref.ssd_scan_ref`` and the
Pallas kernel in interpret mode at ``TestSSDScan``'s shapes (2e-3, the
repo's SSD bar); ``models.ssm.ssd_chunked`` against the JAX package's XLA
``ssd_chunked`` with and without an initial state over several chunks
(1e-5), and its gradients for x, dt, B and C against ``jax.grad``; the
wrapper's checks; and, on a card, the forward kernel against the plain
version and the backward kernel against autograd of the plain chunked
body, in float32 (TF32 off) and bfloat16.

JAX is imported inside the reference helpers only, so that the card's
tests run on a machine without it:
``python -m pytest -q -m cuda tests/test_torch_ssd_scan.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SK
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import ssm

# tests/test_kernels.py::TestSSDScan's shapes
PALLAS_SHAPES = [
    dict(b=2, s=128, h=2, p=32, n=16, chunk=32),
    dict(b=1, s=256, h=4, p=64, n=32, chunk=64),
    dict(b=1, s=64, h=1, p=16, n=8, chunk=64),
]


def _inputs(b, s, h, p, n, seed=0, init=False, **_):
    """x, dt (softplus'd), a (negative), B, C and an optional initial
    state, float32 numpy, from one seed."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, s, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm = (0.5 * rng.standard_normal((b, s, n))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((b, s, n))).astype(np.float32)
    st = ((0.5 * rng.standard_normal((b, h, p, n))).astype(np.float32)
          if init else None)
    return x, dt, a, bm, cm, st


def _t(arrays, device="cpu", dtype=torch.float32):
    """x, B and C in ``dtype``; dt, a and the state float32."""
    x, dt, a, bm, cm, st = arrays
    f = lambda v, d=torch.float32: (None if v is None else
                                    torch.from_numpy(v).to(device, d))
    return f(x, dtype), f(dt), f(a), f(bm, dtype), f(cm, dtype), f(st)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cfg", PALLAS_SHAPES, ids=lambda c: "x".join(
    str(c[k]) for k in ("b", "s", "h", "p", "n", "chunk")))
def test_plain_version_matches_reference_oracle_and_pallas(cfg):
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    arrays = _inputs(**cfg)
    jx = [jnp.asarray(v) for v in arrays[:5]]
    y, st = ops.ssd_scan(*_t(arrays)[:5], chunk=cfg["chunk"])
    for yr, sr in (jref.ssd_scan_ref(*jx),
                   jops.ssd_scan(*jx, chunk=cfg["chunk"], interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=2e-3,
                                   atol=2e-3)


CHUNKED = [
    dict(b=2, s=64, h=3, p=8, n=16, chunk=16, init=False),   # 4 chunks
    dict(b=2, s=64, h=3, p=8, n=16, chunk=16, init=True),
    dict(b=1, s=48, h=2, p=16, n=8, chunk=64, init=True),    # one chunk
]
CHUNKED_IDS = ["4chunks", "4chunks-init", "1chunk-init"]


@pytest.mark.parametrize("cfg", CHUNKED, ids=CHUNKED_IDS)
def test_ssd_chunked_matches_reference(cfg):
    import jax.numpy as jnp

    from repro.models import ssm as jssm

    arrays = _inputs(**cfg)
    jx = [None if v is None else jnp.asarray(v) for v in arrays]
    yr, sr = jssm.ssd_chunked(*jx[:5], cfg["chunk"], jx[5])
    y, st = ssm.ssd_chunked(*_t(arrays)[:5], cfg["chunk"], _t(arrays)[5])
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cfg", CHUNKED, ids=CHUNKED_IDS)
def test_ssd_chunked_gradients_match_jax_grad(cfg):
    """d/d(x, dt, B, C) of sum(y * w) for a fixed random w: the port's
    autograd against ``jax.grad`` of the JAX package's ``ssd_chunked``."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm

    arrays = _inputs(**cfg)
    w = np.random.default_rng(9).standard_normal(
        arrays[0].shape).astype(np.float32)
    x, dt, a, bm, cm, st = arrays

    def jloss(x_, dt_, b_, c_):
        y, _ = jssm.ssd_chunked(x_, dt_, jnp.asarray(a), b_, c_, cfg["chunk"],
                                None if st is None else jnp.asarray(st))
        return jnp.sum(y * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (x, dt, bm, cm)))
    tx, tdt, ta, tb, tc, tst = _t(arrays)
    leaves = [t.requires_grad_() for t in (tx, tdt, tb, tc)]
    y, _ = ssm.ssd_chunked(tx, tdt, ta, tb, tc, cfg["chunk"], tst)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    for g, wv in zip(got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(wv).max()))


def test_ops_entry_runs_the_plain_version_on_the_cpu():
    arrays = _inputs(b=1, s=40, h=2, p=4, n=8, init=True)
    t = _t(arrays)
    y, st = ops.ssd_scan(*t[:5], chunk=20, init_state=t[5])
    yr, sr = ssd_scan_ref(*t)
    assert torch.equal(y, yr) and torch.equal(st, sr)
    assert ops.ssd_scan(*t[:5], chunk=20,
                        out_dtype=torch.float64)[0].dtype == torch.float64
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*t[:5], chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(*t[:5], 16)


@pytest.mark.parametrize("case, exc, match", [
    ("cpu", ValueError, "one CUDA device"),
    ("dtype", TypeError, "share one dtype"),
    ("dt_dtype", TypeError, "dt and a must be float32"),
    ("shape", ValueError, "do not agree"),
    ("chunk", ValueError, "multiple of the chunk"),
    ("init", TypeError, "init_state must be float32"),
    ("width", ValueError, "multiples of 4"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, exc, match):
    """Checked before the library is loaded, so this runs without nvcc."""
    x, dt, a, bm, cm, st = _t(_inputs(b=1, s=64, h=2, p=4, n=8, init=True))
    kw = dict(chunk=32, init_state=None)
    if case == "dtype":
        bm = bm.double()
    elif case == "dt_dtype":
        dt = dt.double()
    elif case == "shape":
        cm = cm[:, :32]
    elif case == "chunk":
        kw["chunk"] = 24
    elif case == "init":
        kw["init_state"] = st[:, :1]
    elif case == "width":
        x = x[..., :3].contiguous()
    with pytest.raises(exc, match=match):
        SK.ssd_scan_fwd_cuda(x, dt, a, bm, cm, **kw)


# ---------------------------------------------------------------------------
# The backward's launch, scratch and head combine (host-side models)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, s, h, want", [
    (48, 64, 64, dict(ctas=3072, cluster=8, groups=8, tiles=2,
                      state_slots=0, launches=2)),    # the adapt shape
    (2, 160, 4, dict(ctas=8, cluster=4, groups=1, tiles=5, state_slots=3,
                     launches=1)),                      # five tiles
    (1, 512, 2, dict(ctas=2, cluster=2, groups=1, tiles=16,
                     state_slots=14, launches=1)),      # the chunk of 256
    (2, 96, 3, dict(ctas=6, cluster=3, groups=1, tiles=3, state_slots=1,
                    launches=1)),
    (1, 40, 12, dict(ctas=12, cluster=6, groups=2, tiles=2, state_slots=0,
                     launches=2)),
    (1, 32, 1, dict(ctas=1, cluster=1, groups=1, tiles=1, state_slots=0,
                    launches=1)),
])
def test_backward_geometry(b, s, h, want):
    """Clusters of the largest divisor of H up to 8 heads, one group
    partial a cluster (a second launch sums them when there are several),
    and a scratch only for the states entering tiles 1 .. nt - 2."""
    assert SK.bwd_geometry(b, s, h) == want


def test_backward_scratch_at_the_adapt_shape():
    """At mamba2-1.3b's adapt shape the backward writes no tile states and
    2 x 12.6 MB of group partials, where the design it replaces wrote
    201 MB of tile states and 2 x 100.7 MB of per-head partials."""
    b, s, h, p, n = 48, 64, 64, 64, 128
    geo = SK.bwd_geometry(b, s, h)
    assert geo["state_slots"] * b * h * p * n == 0
    part_bytes = 2 * b * geo["groups"] * s * n * 4
    assert part_bytes == 25_165_824
    assert part_bytes * 8 == 2 * b * h * s * n * 4  # an eighth of before


@pytest.mark.parametrize("p, n, elt, want", [
    (64, 128, 2, 208960), (64, 128, 4, 229440), (32, 64, 4, 107584),
    (16, 16, 4, 60736)])
def test_backward_shared_memory(p, n, elt, want):
    """Rows padded to 4 words past a multiple of 32, and the staging area
    of the next tile; mamba2-1.3b's widths fit one CTA an SM in both
    dtypes (227 KB)."""
    assert SK.bwd_smem_bytes(p, n, elt) == want <= SK.MAX_SMEM


def _per_head_grads(arrays, chunk):
    """dB and dC of sum(y * w) through the plain chunked body, one head at
    a time (each head's term of the sum over heads), and for all heads."""
    x, dt, a, bm, cm, st = (None if v is None else torch.from_numpy(v)
                            for v in arrays)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        x.shape).astype(np.float32))

    def grads(hs):
        bl, cl = bm.clone().requires_grad_(), cm.clone().requires_grad_()
        y, _ = ssm.ssd_chunked_plain(x[:, :, hs].contiguous(),
                                     dt[:, :, hs].contiguous(), a[hs], bl,
                                     cl, chunk,
                                     None if st is None else st[:, hs])
        return torch.autograd.grad((y * w[:, :, hs]).sum(), (bl, cl))

    h = x.shape[2]
    per = [grads(slice(i, i + 1)) for i in range(h)]
    return (torch.stack([g[0] for g in per], 1),
            torch.stack([g[1] for g in per], 1), grads(slice(0, h)))


@pytest.mark.parametrize("h, cluster", [(8, 8), (8, 4), (16, 8), (6, 3),
                                        (8, 1)])
def test_head_combine_model_matches_plain_and_is_order_free(h, cluster):
    """The backward's fixed-order dB/dC sum over heads (rank order inside a
    cluster, then group order): equal to the plain gradient within
    float32 rounding, and bit for bit the same whatever order the groups'
    CTAs finish in (the kernels combine in rank and group order, never in
    arrival order)."""
    arrays = _inputs(b=2, s=64, h=h, p=8, n=16, init=True)
    db_h, dc_h, (db, dc) = _per_head_grads(arrays, 32)
    for per, want in ((db_h, db), (dc_h, dc)):
        got = SK.combine_heads(per, cluster)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
        order = np.random.default_rng(h + cluster).permutation(h // cluster)
        assert torch.equal(SK.combine_heads(per, cluster,
                                            finish_order=order), got)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

CARD_SHAPES = [
    dict(b=2, s=128, h=4, p=32, n=16, chunk=32, init=False),   # 4 chunks
    dict(b=2, s=96, h=3, p=16, n=24, chunk=48, init=True),     # initial state
    dict(b=1, s=40, h=2, p=16, n=8, chunk=40, init=False),     # ragged tile
    dict(b=1, s=512, h=2, p=64, n=128, chunk=256, init=False),  # Q = 256
    dict(b=48, s=64, h=64, p=64, n=128, chunk=256, init=False),  # adapt shape
    dict(b=2, s=160, h=4, p=32, n=64, chunk=80, init=True),    # 5 tiles
    dict(b=1, s=72, h=12, p=12, n=20, chunk=72, init=True),    # odd widths
]
CARD_IDS = ["4chunks", "init", "ragged", "Q256", "adapt", "5tiles",
            "oddwidths"]
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol, what):
    """Max abs error relative to the reference's largest magnitude."""
    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item() / scale
    assert torch.isfinite(got).all() and err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", CARD_SHAPES, ids=CARD_IDS)
def test_cuda_forward_matches_plain(cuda_device, cfg, dtype):
    t = _t(_inputs(**cfg), cuda_device, dtype)
    before = ops.ssd_scan.launches
    y, st = ops.ssd_scan(*t[:5], chunk=cfg["chunk"], init_state=t[5],
                         out_dtype=torch.float32)
    yr, sr = ssd_scan_ref(t[0].float(), *t[1:])  # float32 y, as the kernel
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, yr, 1e-4, "y")
    _close(st, sr, 1e-4, "final state")
    y2, none = ops.ssd_scan(*t[:5], chunk=cfg["chunk"], init_state=t[5],
                            want_state=False)
    assert none is None and y2.dtype == dtype
    assert torch.equal(y2, y.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", CARD_SHAPES, ids=CARD_IDS)
def test_cuda_backward_matches_autograd_of_plain(cuda_device, cfg, dtype):
    """dx, d(dt), dB, dC of sum(y * w) from the backward kernel against
    autograd of the plain chunked body in float32 on the same (bf16-rounded)
    inputs; the kernel's gradients come back in the inputs' dtype."""
    arrays = _inputs(**cfg)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        arrays[0].shape).astype(np.float32)).to(cuda_device)
    t = _t(arrays, cuda_device, dtype)
    ref = [v.float() for v in (t[0], t[1], t[3], t[4])]
    leaves = [v.clone().requires_grad_() for v in (t[0], t[1], t[3], t[4])]
    ref = [v.clone().requires_grad_() for v in ref]
    before = ops.ssd_scan.bwd_launches
    y, _ = ssm.ssd_chunked(leaves[0], leaves[1], t[2], leaves[2], leaves[3],
                           cfg["chunk"], t[5], need_state=False)
    got = torch.autograd.grad((y * w).sum(), leaves)
    yr, _ = ssm.ssd_chunked_plain(ref[0], ref[1], t[2], ref[2], ref[3],
                                  cfg["chunk"], t[5])
    want = torch.autograd.grad((yr * w).sum(), ref)
    torch.cuda.synchronize()
    assert ops.ssd_scan.bwd_launches == before + 1
    for name, g, wv, leaf in zip(("dx", "d(dt)", "dB", "dC"), got, want,
                                 leaves):
        assert g.dtype == leaf.dtype
        _close(g, wv, CARD_TOL[dtype] if name != "d(dt)" else
               max(CARD_TOL[dtype], 1e-4), name)
    # the same gradients again: no atomics, so bit for bit
    y, _ = ssm.ssd_chunked(leaves[0], leaves[1], t[2], leaves[2], leaves[3],
                           cfg["chunk"], t[5], need_state=False)
    again = torch.autograd.grad((y * w).sum(), leaves)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.cuda
def test_cuda_function_refuses_gradients_it_does_not_give(cuda_device):
    x, dt, a, bm, cm, st = _t(_inputs(b=1, s=64, h=2, p=8, n=8, init=True),
                              cuda_device)
    with pytest.raises(NotImplementedError, match="no gradient for a"):
        ops.ssd_scan(x, dt, a.requires_grad_(), bm, cm, chunk=32)
    with pytest.raises(NotImplementedError, match="no gradient for init"):
        ops.ssd_scan(x, dt, a.detach(), bm, cm, chunk=32,
                     init_state=st.requires_grad_())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", CARD_SHAPES, ids=CARD_IDS)
def test_cuda_backward_launch_matches_the_model(cuda_device, cfg, dtype):
    """The launch the library makes (CTAs, cluster, threads, shared memory,
    scratch states) is the one the host-side model describes, and a
    backward launches the kernels it reports (the forward is not re-run)."""
    b, s, h, p, n = (cfg[k] for k in ("b", "s", "h", "p", "n"))
    geo = SK.bwd_geometry(b, s, h)
    plan = SK.bwd_plan(b, s, h, p, n, dtype)
    assert (plan["CTAs"], plan["cluster"], plan["threads"],
            plan["smem_bytes"], plan["state_slots"]) == (
        geo["ctas"], geo["cluster"], 512,
        SK.bwd_smem_bytes(p, n, 4 if dtype == torch.float32 else 2),
        geo["state_slots"])
    t = _t(_inputs(**cfg), cuda_device, dtype)
    dy = torch.ones((b, s, h, p), device=cuda_device)
    before = SK.bwd_kernels
    SK.ssd_scan_bwd_cuda(dy, *t[:5], chunk=cfg["chunk"], init_state=t[5])
    assert SK.bwd_kernels - before == geo["launches"]
