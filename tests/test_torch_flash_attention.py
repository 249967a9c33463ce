"""The port's cached flash attention against the JAX package's Pallas
kernel (interpret mode on the CPU), its wrapper checks, and — on a card —
the CUDA kernel against its plain version.

JAX is imported inside the reference helper only, so that the card's
tests run on a machine without it:
``python -m pytest -q -m cuda tests/test_torch_flash_attention.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_cached_ref

B, SQ, HQ, HKV, D, SMAX = 3, 8, 4, 2, 32, 64


def _qkv(seed=0, b=B, sq=SQ, hq=HQ, hkv=HKV, d=D, smax=SMAX):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, smax, hkv, d)).astype(np.float32),
            rng.standard_normal((b, smax, hkv, d)).astype(np.float32))


def _pallas(q, k, v, q_off, kv_len, window):
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    return np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len),
        block_q=8, block_k=16, interpret=True))


def _port(q, k, v, q_off, kv_len, window):
    t = torch.from_numpy
    return ops.flash_attention_cached(
        t(q), t(k), t(v), q_offset=t(q_off), kv_len=t(kv_len),
        window=window).numpy()


@pytest.mark.parametrize("window", [0, 16])
def test_plain_matches_pallas_interpret(window):
    """Ragged per-slot cursors: a block at the start, one mid-cache and one
    whose queries run past the valid rows (q_offset + Sq > kv_len)."""
    q, k, v = _qkv()
    q_off = np.asarray([0, 5, 37], np.int32)
    kv_len = q_off + np.asarray([8, 8, 3], np.int32)
    np.testing.assert_allclose(_port(q, k, v, q_off, kv_len, window),
                               _pallas(q, k, v, q_off, kv_len, window),
                               rtol=2e-5, atol=2e-5)


def test_kv_len_zero_row_gives_zero():
    """An empty cache gives 0 in both packages, exactly; the other rows
    still match."""
    q, k, v = _qkv(seed=1)
    q_off = np.asarray([0, 5, 37], np.int32)
    kv_len = np.asarray([0, 13, 40], np.int32)
    got = _port(q, k, v, q_off, kv_len, 0)
    want = _pallas(q, k, v, q_off, kv_len, 0)
    assert np.all(got[0] == 0.0) and np.all(want[0] == 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_row_without_visible_key_gives_zero():
    """A row whose window excludes every valid cache row gives 0 in the
    port.  The Pallas kernel instead averages v over a kv block it visits
    for the same sample (ROADMAP queue 3): the contract says 0."""
    q, k, v = _qkv(seed=2, b=1, hq=2, hkv=1, d=16)
    q_off, kv_len = np.asarray([40], np.int32), np.asarray([20], np.int32)
    got = _port(q, k, v, q_off, kv_len, 16)
    assert np.all(got == 0.0)
    want = _pallas(q, k, v, q_off, kv_len, 16)
    np.testing.assert_allclose(want[0, 0, 0], v[0, 16:32, 0].mean(0),
                               rtol=1e-5, atol=1e-6)


def test_empty_cache_block_row_gives_zero():
    """Block prefill of a slot with nothing in its cache (a free slot): the
    port's block attention gives 0, the JAX package's non-TPU path
    (``dot_attention``, -1e30 masking) the uniform average of the stripe.
    Both are pinned here; 0 is the contract of the JAX package's own
    oracle (``repro/kernels/ref.py:38`` zeroes fully-masked rows), and such
    rows are never emitted (ROADMAP queue 3)."""
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro_torch.models import layers as L

    q, k, v = _qkv(seed=4, b=1)
    zero = np.zeros(1, np.int32)
    t = torch.from_numpy
    got = L._block_cached_attention(t(q), t(k), t(v), lens=t(zero),
                                    n_new=t(zero)).numpy()
    want = np.asarray(JL._block_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lens=jnp.asarray(zero), n_new=jnp.asarray(zero)))
    assert np.all(got == 0.0)
    np.testing.assert_allclose(
        want, np.broadcast_to(np.repeat(v.mean(1, keepdims=True), HQ // HKV,
                                        axis=2), want.shape),
        rtol=1e-5, atol=1e-6)


def _poison_unseen(k, v, q_off, kv_len, window, sq=SQ):
    """Copies of k/v with NaN in every cache row that no query of its
    sample can see: past kv_len, in the causal future of the block, and
    before the window of its first query."""
    k, v = k.copy(), v.copy()
    for b, (qo, kl) in enumerate(zip(q_off, kv_len)):
        lo = max(0, qo - window + 1) if window else 0
        hi = min(kl, qo + sq)
        for x in (k, v):
            x[b, :lo] = np.nan
            x[b, hi:] = np.nan
    return k, v


@pytest.mark.parametrize("window", [0, 16])
def test_rows_no_query_sees_are_never_read(window):
    """A slot's stripe keeps whatever an earlier stream wrote past the new
    stream's length, non-finite rows included; they must not reach the
    output (the CUDA kernel never loads them; the plain version zeroes
    them before its products)."""
    q, k, v = _qkv(seed=3)
    q_off = np.asarray([0, 5, 37], np.int32)
    kv_len = q_off + np.asarray([8, 8, 3], np.int32)
    clean = _port(q, k, v, q_off, kv_len, window)
    pk, pv = _poison_unseen(k, v, q_off, kv_len, window)
    np.testing.assert_array_equal(_port(q, pk, pv, q_off, kv_len, window),
                                  clean)


def test_plain_version_dtype_and_shape():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv())
    off = torch.tensor([0, 5, 37], dtype=torch.int32)
    out = flash_attention_cached_ref(q, k, v, q_offset=off, kv_len=off + 8)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_non_cpu_tensor_never_runs_the_plain_version():
    q, k, v = (torch.from_numpy(a).to("meta") for a in _qkv())
    off = torch.zeros(B, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention_cached(q, k, v, q_offset=off, kv_len=off)


@pytest.mark.parametrize("case, exc, match", [
    ("head_dim", ValueError, "multiple of 16"),
    ("heads", ValueError, "not a multiple of Hkv"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("cursor_dtype", TypeError, "int32"),
    ("device", ValueError, "CUDA device"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc, match):
    """The CUDA wrapper checks its inputs before any launch (reachable on
    the CPU: the device check comes after the shape and type checks)."""
    shapes = dict(d=24) if case == "head_dim" else (
        dict(hq=3) if case == "heads" else {})
    q, k, v = (torch.from_numpy(a) for a in _qkv(**shapes))
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    off = torch.zeros(B, dtype=torch.int64 if case == "cursor_dtype"
                      else torch.int32)
    with pytest.raises(exc, match=match):
        FA.flash_attention_cached_cuda(q, k, v, q_offset=off, kv_len=off)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("shape", [
    dict(b=8, sq=8, hq=12, hkv=2, d=128, smax=512),  # qwen2-1.5b prefill
    dict(b=3, sq=8, hq=4, hkv=2, d=16, smax=48),     # qwen2-smoke
    dict(b=2, sq=5, hq=16, hkv=1, d=256, smax=130),  # ragged edges, 2 CTAs
])
def test_cuda_kernel_matches_plain(cuda_device, shape, window, dtype, tol):
    rng = np.random.default_rng(0)
    b, sq, smax = shape["b"], shape["sq"], shape["smax"]
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(**shape))
    q_off = rng.integers(0, smax - sq + 1, b).astype(np.int32)
    kv_len = np.minimum(q_off + rng.integers(0, sq + 1, b), smax)
    q_off[0], kv_len[0] = 0, 0  # an empty cache
    off = torch.from_numpy(q_off).to(cuda_device)
    kl = torch.from_numpy(kv_len.astype(np.int32)).to(cuda_device)
    n0 = ops.flash_attention_cached.launches
    got = ops.flash_attention_cached(q, k, v, q_offset=off, kv_len=kl,
                                     window=window)
    assert ops.flash_attention_cached.launches == n0 + 1
    want = flash_attention_cached_ref(q, k, v, q_offset=off, kv_len=kl,
                                      window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    assert torch.all(got[0] == 0)
    # stale non-finite rows that no query sees change nothing
    pk, pv = (torch.from_numpy(a).to(cuda_device, dtype) for a in
              _poison_unseen(k.float().cpu().numpy(), v.float().cpu().numpy(),
                             q_off, kv_len, window, sq=sq))
    poisoned = ops.flash_attention_cached(q, pk, pv, q_offset=off,
                                          kv_len=kl, window=window)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, got)
