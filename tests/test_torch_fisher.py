"""The port's Fisher reduction (paper Eq. 2) against the JAX package's
``ops.fisher``, ``fisher_auto`` and ``fisher_tapgrads`` (the Pallas kernel
in interpret mode on the CPU, as ``tests/test_kernels.py`` runs it), with
that file's shapes, dtypes and tolerances; its wrapper checks; and, on a
card, the CUDA kernel against its plain version.

JAX is imported inside the reference helpers only, so that the card's
tests run on a machine without it:
``python -m pytest -q -m cuda tests/test_torch_fisher.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fisher as FK
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fisher_ref, fisher_tapgrads_ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jax(fn, *arrays, dtype="float32", **kw):
    """Run a JAX ``repro.kernels.ops`` entry on numpy inputs."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    args = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return np.asarray(getattr(jops, fn)(*args, **kw), np.float32)


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape,blocks", [
    ((2, 256, 128), (256, 128)),
    ((4, 1024, 512), (512, 256)),
    ((1, 512, 256), (128, 64)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fisher_matches_pallas(shape, blocks, dtype):
    a, g = _normal(shape, 0), _normal(shape, 1, 0.1)
    want = _jax("fisher", a, g, dtype=dtype, block_d=blocks[0],
                block_c=blocks[1])
    got = ops.fisher(_t(a, dtype), _t(g, dtype))
    assert got.dtype == torch.float32 and got.shape == (shape[2],)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("n_valid,n_pad", [(3, 8), (4, 4), (5, 16)])
def test_masked_padding_matches_unpadded(n_valid, n_pad):
    """Garbage in the padding rows: masked rows drop out of the sum and of
    the normaliser, in both packages and through both entries."""
    d, c = 256, 128
    a, g = _normal((n_pad, d, c), 0), _normal((n_pad, d, c), 1, 0.1)
    mask = (np.arange(n_pad) < n_valid).astype(np.float32)
    unpadded = _jax("fisher", a[:n_valid], g[:n_valid], block_d=256,
                    block_c=128)
    for entry in ("fisher", "fisher_auto"):
        kw = dict(block_d=256, block_c=128) if entry == "fisher" else {}
        want = _jax(entry, a, g, mask=mask, **kw)
        got = getattr(ops, entry)(_t(a), _t(g), mask=_t(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, unpadded, rtol=1e-5, atol=1e-6)


def test_shape_no_block_tiles_matches_oracle_fallback():
    """(6, 7, 5) tiles no Pallas block, so the JAX package falls back to its
    plain formula; the port takes the same shape through the kernel path."""
    a, g = _normal((6, 7, 5), 2), _normal((6, 7, 5), 3)
    mask = np.asarray([1, 1, 1, 1, 0, 0], np.float32)
    want = _jax("fisher_auto", a, g, mask=mask)
    got = ops.fisher_auto(_t(a), _t(g), mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 6, 128), (2, 5, 256), (4, 3, 77)])
@pytest.mark.parametrize("masked", [False, True])
def test_tapgrads_match_pallas_route(shape, masked):
    """The probe path's Eq. 2 on tap gradients (L, B, C) -> (L, C), with the
    valid count n != B so the normaliser rescales; 77 channels is the shape
    no Pallas block tiles."""
    l, b, c = shape
    g = _normal(shape, 0)
    n = np.float32(b - 1)
    mask = (np.arange(b) < b - 1).astype(np.float32) if masked else None
    want = _jax("fisher_tapgrads", g, n=n, mask=mask)
    got = ops.fisher_tapgrads(_t(g), float(n),
                              None if mask is None else _t(mask))
    assert got.shape == (l, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_masked_rows_are_never_read():
    """Non-finite garbage in a padded row cannot reach the scores."""
    g = _normal((2, 6, 33), 4)
    mask = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32)
    clean = fisher_tapgrads_ref(torch.from_numpy(g), 4.0, mask)
    g[:, 4], g[:, 5] = np.nan, np.inf
    assert torch.equal(fisher_tapgrads_ref(torch.from_numpy(g), 4.0, mask),
                       clean)
    a = torch.from_numpy(_normal((6, 3, 33), 5))
    bad = torch.from_numpy(_normal((6, 3, 33), 6))
    bad[4:] = float("nan")
    assert torch.isfinite(fisher_ref(a, bad, mask)).all()


def test_all_rows_masked_gives_zero():
    a, g = torch.ones(3, 2, 4), torch.ones(3, 2, 4)
    out = ops.fisher(a, g, mask=torch.zeros(3))
    assert torch.equal(out, torch.zeros(4))


def test_non_cpu_tensor_never_runs_the_plain_version():
    g = torch.zeros(2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.fisher_tapgrads(g, 3.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.fisher(g, g)


@pytest.mark.parametrize("case, exc, match", [
    ("dtype", TypeError, "float32 or bfloat16"),
    ("mixed", TypeError, "float32 or bfloat16"),
    ("mask", TypeError, "mask must be float32"),
    ("no_a", ValueError, "needs the activation operand"),
    ("device", ValueError, "CUDA device"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc, match):
    """The CUDA wrapper checks its inputs before any launch (reachable on
    the CPU: the device check comes after the shape and type checks)."""
    g = torch.zeros(4, 3, 8)
    a = g.clone()
    kw = dict(scale=1.0)
    if case == "dtype":
        a, g = a.half(), g.half()
    elif case == "mixed":
        a = a.to(torch.bfloat16)
    elif case == "mask":
        kw["mask"] = torch.ones(4, dtype=torch.int32)
    elif case == "no_a":
        a = None
    with pytest.raises(exc, match=match):
        FK.fisher_cuda(g, a, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _valid_mask(n, n_valid):
    return (torch.arange(n) < n_valid).float()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(28, 48, 8960), (28, 48, 12), (4, 3, 77)])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_tapgrads_match_plain(cuda_device, shape, dtype, masked):
    """The tap-gradient route at qwen2-1.5b's ffn and mixer shapes and a
    ragged one; masked rows hold NaN and are never read."""
    g = _t(_normal(shape, 0), dtype).to(cuda_device)
    pad = min(3, shape[1] - 1)
    mask = _valid_mask(shape[1], shape[1] - pad).to(cuda_device) if masked \
        else None
    if masked:
        g[:, -pad:] = float("nan")
    n = float(shape[1] - pad)
    n0 = ops.fisher_tapgrads.launches
    got = ops.fisher_tapgrads(g, n, mask)
    assert ops.fisher_tapgrads.launches == n0 + 1
    want = fisher_tapgrads_ref(g, n, mask)
    torch.cuda.synchronize()
    assert got.shape == shape[::2] and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 1024, 512), (6, 7, 77), (5, 1, 300)])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_fisher_matches_plain(cuda_device, shape, dtype, masked):
    """Materialised (N, D, C) operands with ragged D and C tails and
    garbage in the masked rows."""
    a = _t(_normal(shape, 0), dtype).to(cuda_device)
    g = _t(_normal(shape, 1, 0.1), dtype).to(cuda_device)
    mask = _valid_mask(shape[0], shape[0] - 1).to(cuda_device) if masked \
        else None
    n0 = ops.fisher.launches
    got = ops.fisher(a, g, mask=mask)
    assert ops.fisher.launches == n0 + 1
    want = fisher_ref(a, g, mask)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
