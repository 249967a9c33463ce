"""The port's int8 error-feedback quantisation against the JAX package's:
the plain version (``kernels.ref.grad_quant_ref``) against
``repro.kernels.ref.grad_quant_ref`` and ``repro.optim.compress``'s XLA
path (codes, scales and residuals equal) and against the Pallas kernel in
interpret mode (codes equal, scale within 1e-6, residual within 1e-6, as
``tests/test_kernels.py`` holds it: the Pallas kernel multiplies by
1/scale); the tree-level compressor and its error-feedback telescoping;
the wrapper's checks; the kernel's choice of path and its slice-by-slice
arithmetic (host-side models); the per-call bench's CPU smoke; and, on a
card, the CUDA kernel on each path against its plain version, exactly,
and its launch against the model.

JAX is imported inside the reference helpers only, so that the card's
tests run on a machine without it:
``python -m pytest -q -m cuda tests/test_torch_grad_quant.py``."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import grad_quant as GQ
from repro_torch.kernels import ops
from repro_torch.kernels.ref import grad_quant_ref
from repro_torch.optim import compress as C

SIZES = (1, 100, 1024, 5000, 6151)
DTYPES = ("float32", "bfloat16")


def _inputs(n, seed, dtype="float32"):
    """g in ``dtype`` and a float32 residual, numpy float32 (bf16 values
    rounded, so both frameworks see the same numbers)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    if dtype == "bfloat16":
        g = torch.from_numpy(g).bfloat16().float().numpy()
    err = (0.01 * rng.standard_normal(n)).astype(np.float32)
    return g, err


def _ties():
    """absmax 127 makes scale 1 + 1e-12 == 1.0 in float32, so g32/scale
    lands exactly on k + 0.5 for these entries: round half to even."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                  3.25, 0.0], np.float32)
    return g, np.zeros_like(g)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _jax_ref(g, err, dtype="float32"):
    import jax.numpy as jnp

    from repro.kernels import ref as jref

    q, s, e = jref.grad_quant_ref(jnp.asarray(g, getattr(jnp, dtype)),
                                  jnp.asarray(err))
    return np.asarray(q), np.float32(s), np.asarray(e)


def _jax_compress(g, err, dtype="float32"):
    import jax.numpy as jnp

    from repro.optim import compress as jC

    q, s, e = jC.int8_compress({"w": jnp.asarray(g, getattr(jnp, dtype))},
                               {"w": jnp.asarray(err)})
    return np.asarray(q["w"]), np.float32(s["w"]), np.asarray(e["w"])


def _jax_pallas(g, err, dtype="float32"):
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    q, s, e = jops.grad_quant(jnp.asarray(g, getattr(jnp, dtype)),
                              jnp.asarray(err), interpret=True)
    return np.asarray(q), np.float32(s), np.asarray(e)


def _port(g, err, dtype="float32"):
    q, s, e = grad_quant_ref(_t(g, dtype), _t(err))
    return q.numpy(), np.float32(s.item()), e.numpy()


CASES = ([(n, d, "normal") for n in SIZES for d in DTYPES]
         + [(11, "float32", "ties"), (11, "bfloat16", "ties"),
            (1000, "float32", "zeros")])


def _case(n, dtype, kind, seed=0):
    if kind == "ties":
        return _ties()
    if kind == "zeros":
        return np.zeros(n, np.float32), np.zeros(n, np.float32)
    return _inputs(n, seed, dtype)


@pytest.mark.parametrize("n,dtype,kind", CASES)
def test_plain_version_equals_reference_oracle_and_xla_path(n, dtype, kind):
    g, err = _case(n, dtype, kind)
    got = _port(g, err, dtype)
    for want in (_jax_ref(g, err, dtype), _jax_compress(g, err, dtype)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
    if kind == "ties":
        np.testing.assert_array_equal(
            got[0], [127, 0, 2, 2, 0, -2, -2, 126, -126, 3, 0])
    if kind == "zeros":
        assert got[1] == np.float32(1e-12)
        assert not got[0].any() and not got[2].any()


@pytest.mark.parametrize("n,dtype,kind", CASES)
def test_plain_version_matches_pallas_interpret(n, dtype, kind):
    g, err = _case(n, dtype, kind)
    q, s, e = _port(g, err, dtype)
    qk, sk, ek = _jax_pallas(g, err, dtype)
    np.testing.assert_array_equal(q, qk)
    np.testing.assert_allclose(s, sk, rtol=1e-6)
    np.testing.assert_allclose(e, ek, atol=1e-6)


def test_tree_compress_matches_reference():
    import jax
    import jax.numpy as jnp

    from repro.optim import compress as jC

    rng = np.random.default_rng(4)
    shapes = {"L0": {"attn": {"wq": (8, 6), "wo": (6, 8)}},
              "L1": {"mlp": {"w_up": (8, 5), "w_down": (5, 8)}}}
    tree = {lk: {k: {n: (0.1 * rng.standard_normal(s)).astype(np.float32)
                     for n, s in pack.items()}
                 for k, pack in kinds.items()}
            for lk, kinds in shapes.items()}
    jef = jC.ef_state_init(jax.tree_util.tree_map(jnp.asarray, tree))
    ef = C.ef_state_init(_tree(tree))
    for _ in range(3):  # the residual carries over rounds
        jq, js, jef = jC.int8_compress(
            jax.tree_util.tree_map(jnp.asarray, tree), jef)
        q, s, ef = C.int8_compress(_tree(tree), ef)
        jd = jC.int8_decompress(jq, js)
        d = C.int8_decompress(q, s)
        for got, want in ((q, jq), (s, js), (ef, jef), (d, jd)):
            flat_w = jax.tree_util.tree_leaves(want)
            flat_g = _leaves(got)
            assert len(flat_g) == len(flat_w)
            for a, b in zip(flat_g, flat_w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _tree(tree):
    return {lk: {k: {n: torch.from_numpy(v) for n, v in pack.items()}
                 for k, pack in kinds.items()}
            for lk, kinds in tree.items()}


def _leaves(tree):
    # JAX flattens dicts in sorted key order
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_ef_state_init_and_decompress_dtype():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2, 2)}
    ef = C.ef_state_init(tree)
    assert all(v.dtype == torch.float32 and not v.any() for v in ef.values())
    q, s, _ = C.int8_compress(tree, ef)
    d = C.int8_decompress(q, s, dtype=torch.bfloat16)
    assert d["a"].dtype == torch.bfloat16 and d["b"].shape == (2, 2)


def test_error_feedback_telescopes_over_rounds():
    """Sum of K decompressed rounds + the last residual == K × g exactly in
    exact arithmetic; in float32 within a few ulps of K·|g|."""
    g, _ = _inputs(777, 3)
    tree = {"w": torch.from_numpy(g)}
    ef = C.ef_state_init(tree)
    total = torch.zeros(777, dtype=torch.float64)
    K = 6
    for _ in range(K):
        q, s, ef = C.int8_compress(tree, ef)
        total += C.int8_decompress(q, s)["w"].double()
    drift = (total + ef["w"].double() - K * torch.from_numpy(g).double())
    assert drift.abs().max().item() < 1e-5
    # and the residual stays bounded by half a quantisation step
    assert ef["w"].abs().max().item() <= 0.5 * s["w"].item() * (1 + 1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    g = torch.zeros(4)
    with pytest.raises(ValueError):
        GQ.grad_quant_cuda(g, torch.zeros(5))
    with pytest.raises(TypeError):
        GQ.grad_quant_cuda(g.half(), torch.zeros(4))
    with pytest.raises(TypeError):
        GQ.grad_quant_cuda(g, torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        GQ.grad_quant_cuda(torch.zeros(0), torch.zeros(0))
    with pytest.raises(ValueError):  # a CPU tensor is not the kernel's
        GQ.grad_quant_cuda(g, torch.zeros(4))


def test_ops_entry_runs_the_plain_version_on_the_cpu():
    g, err = _inputs(300, 9)
    before = ops.grad_quant.launches
    q, s, e = ops.grad_quant(_t(g), _t(err))
    assert ops.grad_quant.launches == before  # no kernel launched
    want = _port(g, err)
    np.testing.assert_array_equal(q.numpy(), want[0])
    assert s.item() == want[1]


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_wrapper_refuses_pointers_the_vector_loads_cannot_take():
    """The kernel reads g and err 16 bytes a load: a tensor that starts
    off a 16-byte boundary is refused, not run on a slower path."""
    g = torch.zeros(9)[1:]  # 4 bytes past the allocation's boundary
    with pytest.raises(ValueError, match="16-byte"):
        GQ.grad_quant_cuda(g, torch.zeros(8))
    with pytest.raises(ValueError, match="16-byte"):
        GQ.grad_quant_cuda(torch.zeros(8), torch.zeros(9)[1:])


# the main path's largest leaf (qwen2-1.5b's d_model x d_ff / 2) and the
# on-chip capacity of 132 SMs
GQ_LEAF = 1536 * 4480
CAP132 = 132 * GQ.CAP


@pytest.mark.parametrize("n, path, ctas", [
    (1, 0, 1), (GQ.MIN_PER_CTA, 0, 1), (GQ.MIN_PER_CTA + 1, 1, 2),
    (1_000_003, 1, 123), (GQ_LEAF, 1, 132), (CAP132 - 1, 1, 132),
    (CAP132, 1, 132), (CAP132 + 1, 2, 264), (2 * GQ_LEAF, 2, 264)])
def test_plan_chooses_the_path_by_size(n, path, ctas):
    """One CTA up to MIN_PER_CTA elements (no grid barrier), on chip up to
    the SMs' shared memory (slices in whole units of 16, the last one
    ragged, none empty), two passes beyond; one launch each."""
    plan = GQ.plan_model(n)
    assert (plan["path"], plan["ctas"], plan["threads"]) == (path, ctas, 512)
    if path == 1:
        per = plan["per"]
        assert per % GQ.UNIT == 0 and per * ctas >= n > per * (ctas - 1)
        assert plan["smem_bytes"] == 4 * per <= GQ.MAX_SMEM - 256
    if path == 0:
        assert plan["smem_bytes"] == 4 * (-(-n // 16) * 16)


def test_plan_at_the_main_paths_largest_leaf():
    """6,881,280 elements fit on chip: 132 slices of 52,144 floats
    (208,576 B), under the capacity of 7,662,336."""
    assert GQ.capacity() == 7_662_336
    assert GQ.plan_model(GQ_LEAF) == dict(path=1, ctas=132, threads=512,
                                          per=52_144, smem_bytes=208_576)


def _nan_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's max: a NaN on either side wins."""
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(a, float("nan")), torch.maximum(a, b))


def sliced_model(g: torch.Tensor, err: torch.Tensor, sms: int = 132):
    """The kernel's one-pass arithmetic slice by slice, in plain torch on
    the CPU: each CTA's slice of ``plan_model`` (on the two-pass path,
    n cut into as many contiguous slices as CTAs: which CTA takes an
    element changes no bit) forms g32 = g + err and its own absmax slot
    (NaN propagating); the global absmax is the max of the slots in order;
    then each slice quantises its g32 with the one scale.  Returns (q,
    scale, new_err) as ``grad_quant_ref`` does."""
    n = g.numel()
    plan = GQ.plan_model(n, sms)
    per = plan["per"] if plan["path"] < 2 else -(-n // plan["ctas"])
    g32 = g.reshape(-1).float() + err.reshape(-1)
    slices = [g32[lo:lo + per] for lo in range(0, n, per)]
    absmax = torch.zeros((), dtype=torch.float32)
    for s in slices:
        absmax = _nan_max(absmax, s.abs().amax())
    scale = absmax / torch.full((), 127.0) + 1e-12
    qs, es = [], []
    for s in slices:
        q = torch.clamp(torch.round(s / scale), -127, 127).to(torch.int8)
        qs.append(q)
        es.append(s - q.float() * scale)
    return (torch.cat(qs).reshape(g.shape), scale,
            torch.cat(es).reshape(g.shape))


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("n, sms, dtype", [
    (GQ.MIN_PER_CTA + 1, 132, "float32"),    # two slices, the last ragged
    (100_003, 132, "bfloat16"),              # 13 slices
    (50_001, 4, "float32"),                  # 4 slices of a 4-SM card
    (3 * GQ.CAP + 5, 3, "bfloat16"),         # past a 3-SM card's capacity
])
def test_sliced_model_equals_plain(n, sms, dtype, nan):
    """The one-pass kernel's arithmetic slice by slice (each slice's g32
    and absmax slot, the slots' max, one scale, each slice's codes and
    residuals) is bit for bit ``grad_quant_ref``, across slice boundaries,
    with a ragged tail and with a NaN in one slice."""
    g, err = _inputs(n, n % 97, dtype)
    plan = GQ.plan_model(n, sms)
    if nan:
        g[min(n - 1, plan["per"] + 3)] = np.nan  # the second slice
    got = sliced_model(_t(g, dtype), _t(err), sms)
    want = grad_quant_ref(_t(g, dtype), _t(err))
    _assert_same(got, want)
    assert torch.isnan(got[1]).item() == nan


def test_bench_times_every_size_on_the_cpu():
    """``benchmarks_torch/grad_quant_bench.py`` as a CPU smoke: a row a
    size with the wrapper's time and spread, no C entry off the card."""
    spec = importlib.util.spec_from_file_location(
        "grad_quant_bench", pathlib.Path(__file__).resolve().parents[1]
        / "benchmarks_torch" / "grad_quant_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    rec = bench.main(device="cpu", sizes=(1, 4096, 20_000))
    assert rec["device"] == "cpu" and rec["nvidia_smi"] is None
    assert [r["n"] for r in rec["rows"]] == [1, 4096, 20_000]
    for r in rec["rows"]:
        assert 0 < r["ops_ms_min"] <= r["ops_ms"] <= r["ops_ms_max"]
        assert r["entry_ms"] is None


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version, exactly
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,kind",
                         CASES + [(6_881_280 + 37, "float32", "normal"),
                                  (6_881_280 + 37, "bfloat16", "normal")])
def test_cuda_kernel_equals_plain(cuda_device, n, dtype, kind):
    g, err = _case(n, dtype, kind)
    gt, et = _t(g, dtype).to(cuda_device), _t(err).to(cuda_device)
    before = ops.grad_quant.launches
    got = ops.grad_quant(gt, et)
    want = grad_quant_ref(gt, et)
    torch.cuda.synchronize()
    assert ops.grad_quant.launches == before + 1
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["one CTA", "on chip", "capacity - 1",
                                   "capacity", "capacity + 1", "2 leaves"])
def test_cuda_paths_match_the_model_and_equal_plain(cuda_device, where,
                                                    dtype):
    """The launch the library makes is ``plan_model``'s on this card's SMs;
    each path (one CTA, on chip, two passes, chosen by n) gives the plain
    version's codes, scale and residuals exactly, the same bits twice, and
    a NaN in the tensor a NaN scale."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    cap = GQ.capacity(sms)
    n = {"one CTA": 5000, "on chip": GQ_LEAF, "capacity - 1": cap - 1,
         "capacity": cap, "capacity + 1": cap + 1,
         "2 leaves": 2 * GQ_LEAF}[where]
    plan = GQ.grad_quant_plan(n, getattr(torch, dtype))
    model = GQ.plan_model(n, sms)
    assert plan["sms"] == sms
    assert (plan["path"], plan["ctas"], plan["threads"],
            plan["smem_bytes"]) == (model["path"], model["ctas"],
                                    model["threads"], model["smem_bytes"])
    g, err = _inputs(n, 5, dtype)
    g[n // 2] = np.nan if where == "capacity + 1" else g[n // 2]
    gt, et = _t(g, dtype).to(cuda_device), _t(err).to(cuda_device)
    before = ops.grad_quant.launches
    got = ops.grad_quant(gt, et)
    again = ops.grad_quant(gt, et)
    want = grad_quant_ref(gt, et)
    torch.cuda.synchronize()
    assert ops.grad_quant.launches == before + 2
    _assert_same(got, want)
    _assert_same(again, got)
    assert torch.isnan(got[1]).item() == (where == "capacity + 1")


@pytest.mark.cuda
def test_cuda_kernel_nan_propagates_as_plain(cuda_device):
    g, err = _inputs(4099, 1)
    g[1234] = np.nan
    gt, et = _t(g).to(cuda_device), _t(err).to(cuda_device)
    got = ops.grad_quant(gt, et)
    want = grad_quant_ref(gt, et)
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).item()
    _assert_same(got, want)


@pytest.mark.cuda
def test_cuda_tree_compress_launches_once_per_leaf(cuda_device):
    tree = {"L0": {"mlp": {"w_up": torch.randn(64, 9, device=cuda_device),
                           "w_down": torch.randn(9, 64, device=cuda_device)
                           .bfloat16()}}}
    ef = C.ef_state_init(tree)
    before = ops.grad_quant.launches
    q, s, ef2 = C.int8_compress(tree, ef)
    assert ops.grad_quant.launches == before + 2
    cpu = {k: {kk: {n: t.cpu() for n, t in v.items()} for kk, v in d.items()}
           for k, d in tree.items()}
    q_c, s_c, e_c = C.int8_compress(cpu, C.ef_state_init(cpu))
    torch.cuda.synchronize()
    for name in ("w_up", "w_down"):
        assert torch.equal(q["L0"]["mlp"][name].cpu(), q_c["L0"]["mlp"][name])
