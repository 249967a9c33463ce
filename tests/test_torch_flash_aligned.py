"""The port's aligned flash attention (kernel 3) against the JAX package's
Pallas kernel (interpret mode on the CPU) at the configs of
``tests/test_kernels.py``'s ``TestFlashAttention``, its wrapper checks,
and, on a card, the CUDA kernel against its plain version.

JAX is imported inside the reference fixture only, so that the card's
tests run on a machine without it:
``python -m pytest -q -m cuda tests/test_torch_flash_aligned.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_aligned as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

CONFIGS = {  # tests/test_kernels.py, TestFlashAttention.test_vs_oracle
    "gqa_causal": dict(b=2, s=256, hq=4, hkv=2, d=64, causal=True, window=0),
    "mqa_window": dict(b=1, s=512, hq=4, hkv=1, d=64, causal=True,
                       window=128),
    "full": dict(b=2, s=256, hq=2, hkv=2, d=128, causal=False, window=0),
    "odd_heads": dict(b=1, s=384, hq=3, hkv=1, d=32, causal=True, window=0),
}
DTYPES = {"float32": 1e-5, "bfloat16": 3e-2}


def _qkv(cfg, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = cfg["s"] if sk is None else sk
    return (rng.standard_normal((cfg["b"], cfg["s"], cfg["hq"], cfg["d"]),
                                dtype=np.float32),
            rng.standard_normal((cfg["b"], sk, cfg["hkv"], cfg["d"]),
                                dtype=np.float32),
            rng.standard_normal((cfg["b"], sk, cfg["hkv"], cfg["d"]),
                                dtype=np.float32))


@pytest.fixture(scope="module")
def pallas():
    """The Pallas kernel's aligned mode in interpret mode, once per config
    and dtype: inputs rounded to the dtype on the numpy side, so both
    packages see the same bits."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    out = {}
    for name, cfg in CONFIGS.items():
        for dname in DTYPES:
            q, k, v = (jnp.asarray(a, getattr(jnp, dname)) for a in _qkv(cfg))
            got = jops.flash_attention(q, k, v, causal=cfg["causal"],
                                       window=cfg["window"], block_q=128,
                                       block_k=128, interpret=True)
            out[name, dname] = np.asarray(got.astype(jnp.float32))
    return out


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_matches_pallas_interpret(pallas, name, dname):
    cfg = CONFIGS[name]
    dtype = getattr(torch, dname)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(cfg))
    got = ops.flash_attention(q, k, v, causal=cfg["causal"],
                              window=cfg["window"])
    assert got.dtype == dtype and got.shape == q.shape
    tol = DTYPES[dname]
    np.testing.assert_allclose(got.float().numpy(), pallas[name, dname],
                               rtol=tol, atol=tol)


def test_blocking_of_query_rows_changes_nothing():
    """The plain version's row blocks (which let it run at long lengths)
    give the unblocked result, with Sk != Sq and a window smaller than a
    block."""
    cfg = dict(b=1, s=200, hq=4, hkv=2, d=32)
    q, k, v = (torch.from_numpy(a) for a in _qkv(cfg, seed=1, sk=150))
    for causal, window in ((True, 0), (True, 24), (False, 40)):
        whole = flash_attention_ref(q, k, v, causal=causal, window=window,
                                    block=1 << 20)
        blocked = flash_attention_ref(q, k, v, causal=causal, window=window,
                                      block=64)
        assert torch.equal(whole, blocked)


def test_row_that_sees_no_key_gives_zero():
    """Keys shorter than queries and a window: rows past the last key's
    window see nothing and give 0, as the JAX oracle's NaN -> 0 does."""
    cfg = dict(b=1, s=64, hq=2, hkv=1, d=16)
    q, k, v = (torch.from_numpy(a) for a in _qkv(cfg, seed=2, sk=20))
    out = flash_attention_ref(q, k, v, causal=True, window=8)
    assert torch.all(out[:, 27:] == 0) and torch.all(out[:, :27].abs().sum(-1) > 0)


def test_non_cpu_tensor_never_runs_the_plain_version(monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ops, "flash_attention_ref", plain)
    q, k, v = (torch.from_numpy(a).to("meta")
               for a in _qkv(CONFIGS["gqa_causal"]))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("case, exc, match", [
    ("rank", ValueError, r"expected q \(B,Sq,Hq,D\)"),
    ("kv_mismatch", ValueError, r"expected q \(B,Sq,Hq,D\)"),
    ("batch", ValueError, "disagree"),
    ("head_dim_mismatch", ValueError, "disagree"),
    ("heads", ValueError, "not a multiple of Hkv"),
    ("head_dim", ValueError, "multiple of 16"),
    ("head_dim_large", ValueError, "multiple of 16"),
    ("window", ValueError, "window must be"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("mixed_dtype", TypeError, "float32 or bfloat16"),
    ("device", ValueError, "CUDA device"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc, match):
    """The CUDA wrapper checks its inputs before any launch (reachable on
    the CPU: the device check comes after the shape and type checks)."""
    cfg = dict(b=2, s=16, hq=4, hkv=2, d=32)
    if case == "heads":
        cfg["hq"] = 3
    if case == "head_dim":
        cfg["d"] = 24
    if case == "head_dim_large":
        cfg["d"] = 272
    q, k, v = (torch.from_numpy(a) for a in _qkv(cfg))
    kw = {}
    if case == "rank":
        q = q[0]
    if case == "kv_mismatch":
        v = v[:, :8]
    if case == "batch":
        k, v = k[:1], v[:1]
    if case == "head_dim_mismatch":
        k, v = k[..., :16], v[..., :16]
    if case == "window":
        kw["window"] = -1
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    if case == "mixed_dtype":
        k = k.bfloat16()
    with pytest.raises(exc, match=match):
        FA.flash_attention_aligned_cuda(q, k, v, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape", [
    dict(b=2, s=256, hq=4, hkv=2, d=64, causal=True, window=0),
    dict(b=1, s=512, hq=4, hkv=1, d=64, causal=True, window=128),
    dict(b=2, s=256, hq=2, hkv=2, d=128, causal=False, window=0),
    dict(b=1, s=384, hq=3, hkv=1, d=32, causal=True, window=0),
    dict(b=1, s=200, hq=4, hkv=2, d=64, causal=True, window=0, sk=150),
    dict(b=1, s=150, hq=4, hkv=2, d=64, causal=False, window=0, sk=333),
    dict(b=2, s=130, hq=2, hkv=1, d=16, causal=True, window=5),
    dict(b=1, s=96, hq=2, hkv=2, d=256, causal=True, window=40, sk=90),
    dict(b=1, s=70, hq=6, hkv=3, d=208, causal=False, window=0),
])
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype, tol):
    """Causal, full, GQA/MQA, Sk != Sq both ways, a window smaller than
    the 64-row tile, head dims on the tensor-core path (<= 128) and on
    the FMA path (> 128)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(shape, sk=shape.get("sk")))
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=shape["causal"],
                              window=shape["window"])
    assert ops.flash_attention.launches == n0 + 1
    want = flash_attention_ref(q, k, v, causal=shape["causal"],
                               window=shape["window"])
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
