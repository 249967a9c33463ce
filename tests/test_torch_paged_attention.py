"""The port's paged flash attention: its plain version against the JAX
package's paged Pallas kernel (interpret mode on the CPU) and against the
port's cached attention on the same rows laid out contiguously, its wrapper
checks, and, on a card, the CUDA kernel against its plain version and
against the cached kernel.

JAX is imported inside the reference helper only, so that the card's
tests run on a machine without it:
``python -m pytest -q -m cuda tests/test_torch_paged_attention.py``."""
import numpy as np
import pytest
import torch
from test_torch_flash_attention import _assert_close_slots

from repro_torch.kernels import flash_paged as FP
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    flash_attention_cached_ref, flash_attention_paged_ref,
)
from torch_devices import elsewhere


def _pallas_paged(q, kp, vp, table, q_off, kv_len):
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    return np.asarray(jops.paged_flash_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len),
        block_q=q.shape[1], interpret=True))


def _port(q, kp, vp, table, q_off, kv_len):
    t = torch.from_numpy
    return ops.flash_attention_paged(t(q), t(kp), t(vp), t(table),
                                     q_offset=t(q_off),
                                     kv_len=t(kv_len)).numpy()


def _paged_case(seed=0):
    """The JAX package's paged-kernel case (``tests/test_paging.py``):
    page size 4, ragged per-slot tables over a permuted arena with
    unmapped tails, and per-slot offsets."""
    rng = np.random.default_rng(seed)
    b, sq, hq, hkv, d = 3, 8, 4, 2, 16
    ps, n_pages, mp = 4, 10, 6
    kp = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    table = np.full((b, mp), -1, np.int32)
    perm = rng.permutation(n_pages)
    off = 0
    for i, n in enumerate([6, 3, 4]):
        table[i, :n] = perm[off:off + n]
        off += n
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    q_off = np.asarray([10, 2, 7], np.int32)
    kv_len = q_off + np.asarray([8, 5, 8], np.int32)
    return q, kp, vp, table, q_off, kv_len


def test_plain_matches_pallas_interpret():
    case = _paged_case()
    np.testing.assert_allclose(_port(*case), _pallas_paged(*case), atol=1e-5,
                               rtol=1e-5)


def layout(k, v, kv_len, ps, seed, extra_pages=3, fill=None):
    """Lay contiguous rows k/v (B, S, Hkv, D) out in pages of ``ps`` rows
    over a randomly permuted arena.  Slot b maps ceil(kv_len[b] / ps)
    pages; the rest of its table row is -1, and the pages nobody maps
    (``extra_pages`` of them at least) hold ``fill`` (random rows if
    None).  Returns (k_pages, v_pages, table)."""
    rng = np.random.default_rng(seed)
    b, s = k.shape[:2]
    mp = -(-s // ps)
    used = [-(-int(n) // ps) for n in kv_len]
    n_pages = sum(used) + extra_pages
    perm = rng.permutation(n_pages)
    shape = (n_pages, ps) + k.shape[2:]
    if fill is None:
        kp = rng.standard_normal(shape).astype(k.dtype)
        vp = rng.standard_normal(shape).astype(k.dtype)
    else:
        kp, vp = np.full(shape, fill, k.dtype), np.full(shape, fill, k.dtype)
    table = np.full((b, mp), -1, np.int32)
    nxt = 0
    for i in range(b):
        for j in range(used[i]):
            pg = perm[nxt]
            nxt += 1
            table[i, j] = pg
            rows = k[i, j * ps:(j + 1) * ps].shape[0]
            kp[pg, :rows] = k[i, j * ps:j * ps + rows]
            vp[pg, :rows] = v[i, j * ps:j * ps + rows]
    return kp, vp, table


def _contig(seed, b=4, sq=8, hq=6, hkv=2, d=32, s=40):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    q_off = np.asarray([0, 0, 13, s - sq], np.int32)[:b]
    kv_len = np.asarray([0, 5, 21, s], np.int32)[:b]
    return q, k, v, q_off, kv_len


@pytest.mark.parametrize("ps", [1, 5, 16])
def test_plain_matches_cached_on_contiguous_rows(ps):
    """The same rows laid out contiguously (cached attention) and in
    permuted pages with unmapped tails (paged attention): equal outputs,
    with 0 for the empty cache."""
    q, k, v, q_off, kv_len = _contig(ps)
    t = torch.from_numpy
    want = flash_attention_cached_ref(t(q), t(k), t(v), q_offset=t(q_off),
                                      kv_len=t(kv_len)).numpy()
    kp, vp, table = layout(k, v, kv_len, ps, seed=ps)
    got = _port(q, kp, vp, table, q_off, kv_len)
    assert np.all(got[0] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ps", [1, 5, 16])
def test_non_finite_rows_no_query_sees_never_reach_the_output(ps):
    """NaN in every page row nobody maps, and in the mapped rows at or
    past kv_len (the stale tail of a recycled page): the output equals the
    clean one."""
    q, k, v, q_off, kv_len = _contig(ps + 1)
    kp, vp, table = layout(k, v, kv_len, ps, seed=ps)
    clean = _port(q, kp, vp, table, q_off, kv_len)
    pk, pv, _ = layout(k, v, kv_len, ps, seed=ps, fill=np.nan)
    for i, n in enumerate(kv_len):
        for r in range(int(n), table.shape[1] * ps):
            pg = table[i, r // ps]
            if pg >= 0:
                pk[pg, r % ps] = pv[pg, r % ps] = np.nan
    np.testing.assert_array_equal(_port(q, pk, pv, table, q_off, kv_len),
                                  clean)


def test_plain_version_dtype_and_shape():
    q, kp, vp, table, q_off, kv_len = _paged_case()
    t = torch.from_numpy
    out = flash_attention_paged_ref(
        t(q).bfloat16(), t(kp).bfloat16(), t(vp).bfloat16(), t(table),
        q_offset=t(q_off), kv_len=t(kv_len))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_non_cpu_tensor_never_runs_the_plain_version():
    q, kp, vp, table, q_off, kv_len = (elsewhere(torch.from_numpy(a))
                                       for a in _paged_case())
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention_paged(q, kp, vp, table, q_offset=q_off,
                                  kv_len=kv_len)


@pytest.mark.parametrize("case, exc, match", [
    ("head_dim", ValueError, "multiple of 16"),
    ("heads", ValueError, "not a multiple of Hkv"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("table_dtype", TypeError, "page_table must be int32"),
    ("cursor_dtype", TypeError, "int32"),
    ("device", ValueError, "CUDA device"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc, match):
    """The CUDA wrapper checks its inputs before any launch (reachable on
    the CPU: the device check comes after the shape and type checks)."""
    q, kp, vp, table, q_off, kv_len = (torch.from_numpy(a)
                                       for a in _paged_case())
    if case == "head_dim":
        q, kp, vp = q[..., :8], kp[..., :8], vp[..., :8]
    elif case == "heads":
        q = q[:, :, :3]
    elif case == "dtype":
        q, kp, vp = q.half(), kp.half(), vp.half()
    elif case == "table_dtype":
        table = table.long()
    elif case == "cursor_dtype":
        q_off = q_off.long()
    with pytest.raises(exc, match=match):
        FP.flash_attention_paged_cuda(q, kp, vp, table, q_offset=q_off,
                                      kv_len=kv_len)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(shape, seed, dtype, dev):
    """Contiguous rows with ragged cursors (an empty cache first), their
    paged layout, all on the card in ``dtype``."""
    rng = np.random.default_rng(seed)
    b, sq, hq, hkv, d, s = (shape[x] for x in ("b", "sq", "hq", "hkv", "d",
                                                "s"))
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    q_off = rng.integers(0, s - sq + 1, b).astype(np.int32)
    kv_len = np.minimum(q_off + rng.integers(0, sq + 1, b), s).astype(np.int32)
    q_off[0], kv_len[0] = 0, 0
    kp, vp, table = layout(k, v, kv_len, shape["ps"], seed)
    on = (lambda a: torch.from_numpy(a).to(dev, dtype))
    ints = (lambda a: torch.from_numpy(a).to(dev))
    return (on(q), on(k), on(v), on(kp), on(vp), ints(table), ints(q_off),
            ints(kv_len))


SHAPES = [
    dict(b=8, sq=8, hq=12, hkv=2, d=128, s=512),  # qwen2-1.5b prefill
    dict(b=3, sq=8, hq=4, hkv=2, d=16, s=48),     # qwen2-smoke
    dict(b=2, sq=5, hq=16, hkv=1, d=256, s=130),  # ragged edges, 2 CTAs
    dict(b=8, sq=8, hq=32, hkv=8, d=160, s=512),  # stablelm-12b prefill
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ps", [1, 5, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain_and_cached_kernel(cuda_device, shape, ps,
                                                     dtype, tol):
    """Within tolerance of the plain version; bit for bit the cached
    kernel's output on the same rows laid out contiguously; 0 for the
    empty cache."""
    q, k, v, kp, vp, table, off, kl = _card_case(dict(shape, ps=ps), ps,
                                                 dtype, cuda_device)
    n0 = ops.flash_attention_paged.launches
    got = ops.flash_attention_paged(q, kp, vp, table, q_offset=off,
                                    kv_len=kl)
    assert ops.flash_attention_paged.launches == n0 + 1
    want = flash_attention_paged_ref(q, kp, vp, table, q_offset=off,
                                     kv_len=kl)
    cached = ops.flash_attention_cached(q, k, v, q_offset=off, kv_len=kl)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_close_slots(got, want, tol)
    assert torch.equal(got, cached)
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [1, 5, 16])
def test_cuda_kernel_never_reads_unseen_rows(cuda_device, ps):
    """NaN in unmapped pages and in mapped rows at or past kv_len changes
    nothing."""
    shape = dict(SHAPES[0], ps=ps)
    q, k, v, kp, vp, table, off, kl = _card_case(shape, ps, torch.float32,
                                                 cuda_device)
    clean = ops.flash_attention_paged(q, kp, vp, table, q_offset=off,
                                      kv_len=kl)
    pk, pv = kp.clone(), vp.clone()
    mapped = torch.zeros(pk.shape[0], dtype=torch.bool, device=cuda_device)
    mapped[table[table >= 0].long()] = True
    pk[~mapped] = float("nan")
    pv[~mapped] = float("nan")
    tab, lens = table.cpu().numpy(), kl.cpu().numpy()
    for i, n in enumerate(lens):
        for r in range(int(n), tab.shape[1] * ps):
            pg = int(tab[i, r // ps])
            if pg >= 0:
                pk[pg, r % ps] = float("nan")
                pv[pg, r % ps] = float("nan")
    got = ops.flash_attention_paged(q, pk, pv, table, q_offset=off,
                                    kv_len=kl)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


# the split over the kv axis at its edges (csrc/flash_block.cuh): (what,
# shape, kv_len); each block ends at its slot's last row
SPLIT_CASES = [
    ("tile edges, cache 1024", dict(b=7, sq=8, hq=12, hkv=2, d=128, s=1024),
     [0, 1, 63, 64, 65, 1021, 1024]),
    ("tile edges, cache 4096", dict(b=7, sq=8, hq=12, hkv=2, d=128, s=4096),
     [0, 1, 63, 64, 65, 4000, 4096]),
    ("decode, cache 4096", dict(b=7, sq=1, hq=12, hkv=2, d=128, s=4096),
     [0, 1, 63, 64, 65, 2049, 4096]),
    ("128 rows a group", dict(b=3, sq=16, hq=16, hkv=2, d=128, s=512),
     [0, 116, 512]),
    ("D 64", dict(b=4, sq=8, hq=8, hkv=2, d=64, s=1024), [0, 63, 65, 1024]),
    ("D 256", dict(b=4, sq=8, hq=4, hkv=1, d=256, s=1024), [0, 63, 65, 1024]),
    ("D 160", dict(b=4, sq=8, hq=8, hkv=2, d=160, s=1024), [0, 63, 65, 1024]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ps", [1, 5, 16])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_cuda_split_cases_equal_the_cached_kernel(cuda_device, case, ps,
                                                  dtype, tol):
    """Caches of several tiles a CTA and kv_len around tile edges: within
    tolerance of the plain version, bit for bit the cached kernel's output on
    the same rows, 0 for the empty cache, the same bits on a second run, and
    NaN in unmapped pages and in mapped rows at or past kv_len changes
    nothing."""
    _, shape, kv_len = case
    rng = np.random.default_rng(ps)
    b, sq, hq, hkv, d, s = (shape[x] for x in ("b", "sq", "hq", "hkv", "d",
                                                "s"))
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    kv_len = np.asarray(kv_len, np.int32)
    q_off = np.maximum(kv_len - sq, 0).astype(np.int32)
    kp, vp, table = layout(k, v, kv_len, ps, seed=ps)
    pk, pv, _ = layout(k, v, kv_len, ps, seed=ps, fill=np.nan)
    for i, n in enumerate(kv_len):
        for r in range(int(n), table.shape[1] * ps):
            pg = table[i, r // ps]
            if pg >= 0:
                pk[pg, r % ps] = pv[pg, r % ps] = np.nan
    on = (lambda a: torch.from_numpy(a).to(cuda_device, dtype))
    ints = (lambda a: torch.from_numpy(a).to(cuda_device))
    q, k, v, kp, vp, pk, pv = map(on, (q, k, v, kp, vp, pk, pv))
    table, off, kl = map(ints, (table, q_off, kv_len))
    got = ops.flash_attention_paged(q, kp, vp, table, q_offset=off, kv_len=kl)
    again = ops.flash_attention_paged(q, kp, vp, table, q_offset=off,
                                      kv_len=kl)
    poisoned = ops.flash_attention_paged(q, pk, pv, table, q_offset=off,
                                         kv_len=kl)
    cached = ops.flash_attention_cached(q, k, v, q_offset=off, kv_len=kl)
    want = flash_attention_paged_ref(q, kp, vp, table, q_offset=off,
                                     kv_len=kl)
    torch.cuda.synchronize()
    _assert_close_slots(got, want, tol)
    assert torch.equal(got, cached)
    assert torch.all(got[0] == 0)
    assert torch.equal(got, again)
    assert torch.equal(poisoned, got)
