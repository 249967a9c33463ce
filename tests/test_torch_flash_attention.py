"""The port's cached flash attention against the JAX package's Pallas
kernel (interpret mode on the CPU), its wrapper checks, and — on a card —
the CUDA kernel against its plain version.

JAX is imported inside the reference helper only, so that the card's
tests run on a machine without it:
``python -m pytest -q -m cuda tests/test_torch_flash_attention.py``."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_flash_aligned import _assert_close

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_cached_ref
from torch_devices import elsewhere

B, SQ, HQ, HKV, D, SMAX = 3, 8, 4, 2, 32, 64


def _assert_close_slots(got, want, tol):
    """Kernels 2 and 4's gate: ``_assert_close`` on the whole output, and
    in bf16 each slot (batch row) b also within ``tol |want| + min(tol,
    0.1 rms(want[b]))``.  A slot with a few visible keys has rms near 1
    and one with thousands near 0.02, so the whole output's rms is set by
    the short slots; the per-slot term sees a fault confined to the long
    ones (``test_per_slot_gate_sees_a_fault_in_the_longest_slot_only``)."""
    _assert_close(got, want, tol)
    if got.dtype == torch.bfloat16:
        for b in range(got.shape[0]):
            _assert_close(got[b], want[b], tol)


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
    q, k, v = (elsewhere(torch.from_numpy(a)) for a in _qkv())
    off = elsewhere(torch.zeros(B, dtype=torch.int32))
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
    dict(b=8, sq=8, hq=32, hkv=8, d=160, smax=512),  # stablelm-12b prefill
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
    _assert_close_slots(got, want, tol)
    assert torch.all(got[0] == 0)
    # stale non-finite rows that no query sees change nothing
    pk, pv = (torch.from_numpy(a).to(cuda_device, dtype) for a in
              _poison_unseen(k.float().cpu().numpy(), v.float().cpu().numpy(),
                             q_off, kv_len, window, sq=sq))
    poisoned = ops.flash_attention_cached(q, pk, pv, q_offset=off,
                                          kv_len=kl, window=window)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, got)


# -- the split over the kv axis (csrc/flash_block.cuh) -------------------------

BN, MAX_SPLIT = 64, 8  # the kernels' logical tile rows and cluster size


def _split_combine(q, k, v, q_off, kv_len, window, n_split=None,
                   drop_rank=None, edge_unmasked=False, double_rank=None,
                   drop_tile=None, double_tile=None, fault_slots=None,
                   mma=False, ksteps=None, ncols=None):
    """The kernels' split-and-combine algebra in plain float32 torch, in
    their order: 64-row tiles from row 0; the band's n tiles dealt out in
    runs of ceil(n / 8) to ``n_split`` ranks (the kernels' cluster size by
    default); per rank an online softmax in base 2 from the sentinel (m =
    -1e30, l = 0, acc = 0), rows outside the band zero-filled; then M = max
    m_j, e_j = 2^(m_j - M), out = sum e_j acc_j / max(sum e_j l_j, 1e-30) in
    rank order.  Causal.  ``mma`` takes the bf16 path's products (on inputs
    already rounded to bf16): S summed over 16-deep k-steps in order, then
    acc scaled by the correction and P rounded to bf16 added 16 keys at a
    time, as mma.sync accumulates them; l sums the unrounded P.  Planted
    faults of that path: ``ksteps`` keeps only the first k-steps of S, and
    ``ncols`` leaves the accumulator's columns from there on unwritten.
    Planted faults of the split for the gate's tests:
    ``drop_rank`` leaves that rank out of the combine's sums,
    ``double_rank`` adds that rank twice, ``drop_tile``/``double_tile``
    skip or repeat that 64-row tile (an index into the band) in its rank's
    loop, and ``edge_unmasked`` masks nothing below the window in the
    band's first tile; ``fault_slots`` (default all) are the slots a fault
    touches."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if n_split is None:
        n_split = 1
        while n_split < MAX_SPLIT and n_split < -(-sk // BN):
            n_split *= 2
    scale = math.log2(math.e) / math.sqrt(d)
    out = torch.zeros(b, sq, hq, d)
    for bi in range(b):
        qo, kl = int(q_off[bi]), int(kv_len[bi])
        hi = min(kl, sk, qo + sq)
        lo = max(0, qo - window + 1) if window else 0
        t_lo = lo // BN
        n = -(-hi // BN) - t_lo if hi > lo else 0
        per = -(-n // MAX_SPLIT)
        qpos = qo + torch.arange(sq).repeat(group)           # (group * Sq,)
        for h in range(hkv):
            qr = q[bi, :, h * group:(h + 1) * group].permute(1, 0, 2)
            qr = qr.reshape(group * sq, d)                     # (head, token)
            parts = []
            for rank in range(n_split):
                t0 = t_lo + min(n, rank * per)
                t1 = t_lo + min(n, (rank + 1) * per)
                m = torch.full((group * sq,), -1e30)
                l = torch.zeros(group * sq)
                acc = torch.zeros(group * sq, d)
                faulty = fault_slots is None or bi in fault_slots
                walk = [t for t in range(t0, t1)
                        if not (faulty and t - t_lo == drop_tile)
                        for _ in range(2 if faulty and t - t_lo == double_tile
                                       else 1)]
                for t in walk:
                    s = torch.arange(t * BN, (t + 1) * BN)
                    edge = edge_unmasked and t == t_lo and faulty
                    inb = ((s >= lo) | edge) & (s < hi)
                    rows = s.clamp(max=sk - 1)
                    kt = torch.where(inb[:, None], k[bi, rows, h], 0.0)
                    vt = torch.where(inb[:, None], v[bi, rows, h], 0.0)
                    vis = inb[None] & (s[None] <= qpos[:, None])
                    if window and not edge:
                        vis = vis & (s[None] > qpos[:, None] - window)
                    if mma:
                        sc = torch.zeros(group * sq, BN)
                        for kk in range(0, d if ksteps is None
                                        else 16 * ksteps, 16):
                            sc += qr[:, kk:kk + 16] @ kt[:, kk:kk + 16].T
                    else:
                        sc = qr @ kt.T
                    sc = torch.where(vis, sc * scale, -math.inf)
                    m_new = torch.maximum(m, sc.amax(1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[:, None])
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None]
                    if mma:
                        pb = p.bfloat16().float()
                        for j in range(0, BN, 16):
                            acc += pb[:, j:j + 16] @ vt[j:j + 16]
                        if ncols is not None:
                            acc[:, ncols:] = 0
                    else:
                        acc = acc + p @ vt
                    m = m_new
                parts.append((m, l, acc))
            big_m = torch.stack([pt[0] for pt in parts]).amax(0)
            num, den = torch.zeros(group * sq, d), torch.zeros(group * sq)
            for rank, (m, l, acc) in enumerate(parts):
                times = 1
                if faulty and rank == drop_rank:
                    times = 0
                elif faulty and rank == double_rank:
                    times = 2
                e = torch.exp2(m - big_m)
                for _ in range(times):
                    den = den + l * e
                    num = num + acc * e[:, None]
            o = num / den.clamp_min(1e-30)[:, None]
            out[bi, :, h * group:(h + 1) * group] = o.reshape(
                group, sq, d).permute(1, 0, 2)
    return out


def test_split_combine_algebra_matches_the_plain_version():
    """The split's arithmetic before any card runs it: caches of several
    tiles a rank (1100 rows: 18 tiles, runs of 3), ranks left empty (short
    bands), a window whose band starts deep in the cache, rows that see no
    key (an empty cache; a window past every valid row), against
    ``flash_attention_cached_ref`` at 1e-6; and the trailing empty ranks add
    exact zeros, so 8 ranks give the kernels' cluster size's bits."""
    rng = np.random.default_rng(7)
    b, sq, hq, hkv, d, sk = 6, 8, 4, 2, 16, 1100
    q = torch.from_numpy(rng.standard_normal((b, sq, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, sk, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, sk, hkv, d)).astype(np.float32))
    for window, q_off, kv_len in (
            (0, [0, 0, 56, 1092, 500, 1000], [0, 1, 64, 1100, 505, 1008]),
            (100, [1000, 300, 0, 1092, 64, 60], [1008, 120, 8, 1100, 65, 63])):
        q_off = np.asarray(q_off, np.int32)
        kv_len = np.asarray(kv_len, np.int32)
        got = _split_combine(q, k, v, q_off, kv_len, window)
        want = flash_attention_cached_ref(
            q, k, v, q_offset=torch.from_numpy(q_off),
            kv_len=torch.from_numpy(kv_len), window=window)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert torch.all(got[kv_len == 0] == 0)
        if window:  # slot 1: queries 300..307 see no row below 120
            assert torch.all(got[1] == 0)
        assert torch.equal(got, _split_combine(q, k, v, q_off, kv_len,
                                               window, n_split=MAX_SPLIT))
        assert torch.equal(_split_combine(q[:, :, :2], k[:, :512, :1],
                                          v[:, :512, :1], q_off.clip(0, 504),
                                          kv_len.clip(0, 512), window),
                           _split_combine(q[:, :, :2], k[:, :512, :1],
                                          v[:, :512, :1], q_off.clip(0, 504),
                                          kv_len.clip(0, 512), window,
                                          n_split=2 * MAX_SPLIT))


# chip_smoke.py's 4096-row cache (LONG) at qwen2-1.5b's block-prefill widths
LONG_KV_LEN = [0, 8, 700, 1500, 2600, 3333, 4000, 4096]
# (what, slots of LONG_KV_LEN, window, planted fault, whether the old fixed
# gate 3e-2 + 3e-2 |want| rejects it too)
GATE_FAULTS = [
    ("split rank 3 dropped", slice(None), 0, dict(drop_rank=3), True),
    ("window 1024 edge unmasked", slice(None), 1024,
     dict(edge_unmasked=True), True),
    ("window 2048 edge unmasked, two longest slots", slice(6, None), 2048,
     dict(edge_unmasked=True), False),
]


@pytest.fixture
def one_thread():
    """The split loop's products are tiny: several CPU threads per op only
    contend, and the parallel test run slows them most."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", GATE_FAULTS, ids=[c[0] for c in GATE_FAULTS])
def test_bf16_gate_sees_a_dropped_split_rank_or_an_unmasked_window_edge(
        case, one_thread):
    """The CPU twin of the card's planted-fault test for kernels 2 and 4:
    the split-KV combine at chip_smoke.py's 4096-row cache (Sq 8, Hq 12,
    Hkv 2, D 128, blocks ending at each slot's last row), on bf16-rounded
    inputs, with one split rank left out of the combine or the window's
    edge tile left unmasked, fails the bf16 gate ``3e-2 |want| + min(3e-2,
    0.1 rms(want))``; the exact output rounded to bf16 passes it.  Where
    the old fixed gate passes the fault, the case says so."""
    _, slots, window, fault, old_gate_sees = case
    kv_len = np.asarray(LONG_KV_LEN, np.int32)[slots]
    q_off = np.maximum(kv_len - 8, 0).astype(np.int32)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .bfloat16().float() for shape in
               ((8, 8, 12, 128), (8, 4096, 2, 128), (8, 4096, 2, 128)))
    q, k, v = q[slots], k[slots], v[slots]
    exact = _split_combine(q, k, v, q_off, kv_len, window)
    _assert_close(exact.bfloat16(), exact, 3e-2)
    bad = _split_combine(q, k, v, q_off, kv_len, window, **fault).bfloat16()
    with pytest.raises(AssertionError):
        _assert_close(bad, exact, 3e-2)
    old_gate_passes = bool(np.allclose(bad.float().numpy(), exact.numpy(),
                                       rtol=3e-2, atol=3e-2))
    assert old_gate_passes != old_gate_sees


# (what, fault, whether the whole-output gate rejects it too)
SLOT_FAULTS = [
    ("a dropped tile", dict(drop_tile=37), False),
    ("a doubled tile", dict(double_tile=0), False),
    ("a dropped split rank", dict(drop_rank=5), True),
    ("a doubled split rank", dict(double_rank=2), True),
]


@pytest.mark.parametrize("case", SLOT_FAULTS, ids=[c[0] for c in SLOT_FAULTS])
def test_per_slot_gate_sees_a_fault_in_the_longest_slot_only(case,
                                                             one_thread):
    """A split-KV combine fault confined to LONG's longest slot (4096 rows,
    8 ranks of 8 tiles, outputs of rms ~0.02) on bf16-rounded inputs: the
    per-slot gate rejects each; the exact output rounded to bf16 passes.
    The whole-output gate's absolute term is set by the 8-key slot (rms
    near 1, 0.024 here against the slot's own 0.0026): it passes a dropped
    or doubled 64-row tile of the long slot (errors up to 0.017 and 0.018)
    and sees a dropped or doubled rank of 512 rows (up to ~0.04)."""
    _, fault, whole_sees = case
    kv_len = np.asarray(LONG_KV_LEN, np.int32)
    q_off = np.maximum(kv_len - 8, 0).astype(np.int32)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .bfloat16().float() for shape in
               ((8, 8, 12, 128), (8, 4096, 2, 128), (8, 4096, 2, 128)))
    exact = _split_combine(q, k, v, q_off, kv_len, 0)
    _assert_close_slots(exact.bfloat16(), exact, 3e-2)
    bad = _split_combine(q, k, v, q_off, kv_len, 0, fault_slots={7},
                         **fault).bfloat16()
    assert torch.equal(bad[:7], exact[:7].bfloat16())
    with pytest.raises(AssertionError):
        _assert_close_slots(bad, exact, 3e-2)
    try:
        _assert_close(bad, exact, 3e-2)
        whole_passes = True
    except AssertionError:
        whole_passes = False
    assert whole_passes != whole_sees


# -- the launch and the bf16 path's arithmetic past D 128 --------------------

HEADER = (Path(FA.__file__).resolve().parents[1] / "csrc"
          / "flash_block.cuh")


def test_block_plan_model_mirrors_the_header():
    """``block_plan_model``'s tiles are the header's, and the header's
    ``launch`` sends every bf16 head dim to the tensor cores (the FMA loops
    are f32's alone), with Q's fragments in shared memory past D 128."""
    src = HEADER.read_text()
    consts = {name: int(val) for name, val in re.findall(
        r"constexpr (?:int|size_t) (BM|BN|MAX_SPLIT|SMEM_MAX) = (\d+);", src)}
    assert consts == dict(BM=FA.BM, BN=FA.BN, MAX_SPLIT=FA.MAX_SPLIT,
                          SMEM_MAX=FA.SMEM_MAX)
    mma = re.findall(r"constexpr bool MMA = ([^;]*);", src)
    assert mma == ["std::is_same<T, __nv_bfloat16>::value"]
    assert re.findall(r"constexpr bool QSM = ([^;]*);", src) == [
        "MMA && D > 128"]


# row sources and the cluster each gives: contiguous caches of 8 to 4096
# rows, page tables of 1- to 16-row pages (chip_smoke.py's max_len 512 and
# 768 among them), and a 65,536-row table of 4-row pages, whose rank reads
# a run of 2,049 table entries into shared memory beside the tiles
PLAN_ROWS = [(("contig", 8), 1), (("contig", 100), 2), (("contig", 200), 4),
             (("contig", 512), 8), (("contig", 768), 8), (("contig", 4096), 8),
             (("paged", 16, 32), 8), (("paged", 16, 48), 8),
             (("paged", 5, 103), 8), (("paged", 1, 4096), 8),
             (("paged", 4, 16384), 8)]
# (B, Sq, Hq, Hkv): gemma-2b's and stablelm-12b's block prefill, a decode,
# block_score's block of 32
PLAN_HEADS = [(8, 8, 8, 1), (8, 8, 32, 8), (8, 1, 12, 2), (8, 32, 12, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", range(16, 257, 16))
def test_block_plan_model_fits_every_head_dim(d, dtype):
    """What the compiler does not check, at every head dim and both dtypes:
    the launch with a paged rank's run of table entries still fits a
    block's 232,448 bytes of shared memory (the header's static_assert
    covers the tiles alone), the cluster each row source gets, and the
    path: bf16 runs 128 threads on the tensor cores with two stages, Q
    from registers up to D 128 and from shared memory past it (172,544
    bytes at D 256 on a contiguous cache), f32 the FMA loops' 256
    threads."""
    for rows, cluster in PLAN_ROWS:
        for b, sq, hq, hkv in PLAN_HEADS:
            plan = FA.block_plan_model(b, sq, hq, hkv, d, dtype, rows)
            assert plan["smem_bytes"] <= FA.SMEM_MAX
            assert plan["cluster"] == cluster
            if dtype == torch.bfloat16:
                assert (plan["path"], plan["threads"], plan["stages"]) == (
                    "mma", 128, 2)
                assert plan["q_tile"] == ("shared" if d > 128
                                          else "registers")
                if d == 256 and rows[0] == "contig":
                    assert plan["smem_bytes"] == 172544
            else:
                assert (plan["path"], plan["threads"]) == ("fma", 256)


def _mma_case(d, hq, seed=5):
    """bf16 q, k, v over one kv head (B 4, Sq 8, a 256-row cache: four
    tiles, a cluster of 4) and blocks ending at each slot's last row, from
    an empty cache to a full one."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .bfloat16() for shape in ((4, 8, hq, d), (4, 256, 1, d),
                                         (4, 256, 1, d)))
    kv_len = np.asarray([0, 70, 200, 256], np.int32)
    return q, k, v, np.maximum(kv_len - 8, 0).astype(np.int32), kv_len


def _mma_ref(q, k, v, q_off, kv_len, window):
    return flash_attention_cached_ref(q, k, v, q_offset=torch.from_numpy(q_off),
                                      kv_len=torch.from_numpy(kv_len),
                                      window=window)


# (D, query heads over one kv head, window): stablelm-12b's group of 4 (32
# rows a CTA: two warps idle) at D 144 and 160, gemma-2b's of 8 (64 rows)
# at D 256, with and without a window
MMA_CASES = [(144, 4, 0), (160, 4, 0), (160, 4, 100), (256, 8, 0),
             (256, 8, 100)]


@pytest.mark.parametrize("d, hq, window", MMA_CASES)
def test_mma_path_past_d128_within_the_bf16_gate(d, hq, window, one_thread):
    """The bf16 path's arithmetic at D 144-256 (``_split_combine(mma=True)``:
    S over D / 16 k-steps, P rounded to bf16, 16 keys a k-step) lies
    within kernels 2 and 4's bf16 gate of the plain version, whole and per
    slot, and gives exactly 0 for the empty cache."""
    q, k, v, q_off, kv_len = _mma_case(d, hq)
    got = _split_combine(q.float(), k.float(), v.float(), q_off, kv_len,
                         window, mma=True).bfloat16()
    _assert_close_slots(got, _mma_ref(q, k, v, q_off, kv_len, window), 3e-2)
    assert torch.all(got[0] == 0)


MMA_FAULTS = [("k-steps past column 128 dropped", dict(ksteps=8)),
              ("n-tiles past column 128 unwritten", dict(ncols=128))]


@pytest.mark.parametrize("case", MMA_FAULTS, ids=[c[0] for c in MMA_FAULTS])
@pytest.mark.parametrize("d, hq", [(160, 4), (256, 8)])
def test_bf16_gate_rejects_a_planted_mma_fault(d, hq, case, one_thread):
    """A path that stops at D 128 (the k-steps of S past column 128
    dropped, or the accumulator's n-tiles past it never written) fails the
    bf16 gate at D 160 and 256."""
    q, k, v, q_off, kv_len = _mma_case(d, hq)
    bad = _split_combine(q.float(), k.float(), v.float(), q_off, kv_len, 0,
                         mma=True, **case[1]).bfloat16()
    with pytest.raises(AssertionError):
        _assert_close_slots(bad, _mma_ref(q, k, v, q_off, kv_len, 0), 3e-2)


# (what, shape, q_offset, kv_len, window); q_offset None: kv_len - Sq, from 0
SPLIT_CASES = [
    ("tile edges, cache 1024", dict(b=7, sq=8, hq=12, hkv=2, d=128, smax=1024),
     None, [0, 1, 63, 64, 65, 1021, 1024], 0),
    ("tile edges, cache 4096, Sq 8",
     dict(b=7, sq=8, hq=12, hkv=2, d=128, smax=4096),
     None, [0, 1, 63, 64, 65, 4000, 4096], 0),
    ("decode, cache 4096", dict(b=7, sq=1, hq=12, hkv=2, d=128, smax=4096),
     None, [0, 1, 63, 64, 65, 2049, 4096], 0),
    ("window past most splits", dict(b=3, sq=8, hq=12, hkv=2, d=128,
                                     smax=4096),
     [4000, 200, 3000], [4008, 100, 3008], 100),
    ("128 rows a group", dict(b=3, sq=16, hq=16, hkv=2, d=128, smax=512),
     [0, 100, 496], [0, 116, 512], 0),
    ("D 64", dict(b=4, sq=8, hq=8, hkv=2, d=64, smax=1024),
     None, [0, 63, 65, 1024], 0),
    ("D 256", dict(b=4, sq=8, hq=4, hkv=1, d=256, smax=1024),
     None, [0, 63, 65, 1024], 0),
    ("D 160", dict(b=4, sq=8, hq=8, hkv=2, d=160, smax=1024),
     None, [0, 63, 65, 1024], 0),
]


def _split_case(case, dtype, dev):
    """(q, k, v, q_offset, kv_len) of a SPLIT_CASES entry on the card, and
    the slots whose rows see no key."""
    _, shape, q_off, kv_len, window = case
    q, k, v = _qkv(seed=11, **shape)
    kv_len = np.asarray(kv_len, np.int32)
    q_off = (np.maximum(kv_len - shape["sq"], 0) if q_off is None
             else np.asarray(q_off)).astype(np.int32)
    blind = [i for i in range(len(kv_len))
             if min(kv_len[i], q_off[i] + shape["sq"])
             <= (max(0, q_off[i] - window + 1) if window else 0)]
    on = (lambda a: torch.from_numpy(a).to(dev, dtype))
    ints = (lambda a: torch.from_numpy(a).to(dev))
    return on(q), on(k), on(v), ints(q_off), ints(kv_len), blind


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_cuda_split_cases(cuda_device, case, dtype, tol):
    """The split over the kv axis at its edges: within tolerance of the
    plain version, exactly 0 where a row sees no key, the same bits on a
    second run, and NaN in every row no query sees changes nothing."""
    window = case[4]
    q, k, v, off, kl, blind = _split_case(case, dtype, cuda_device)
    got = ops.flash_attention_cached(q, k, v, q_offset=off, kv_len=kl,
                                     window=window)
    again = ops.flash_attention_cached(q, k, v, q_offset=off, kv_len=kl,
                                       window=window)
    want = flash_attention_cached_ref(q, k, v, q_offset=off, kv_len=kl,
                                      window=window)
    pk, pv = (torch.from_numpy(a).to(cuda_device, dtype) for a in
              _poison_unseen(k.float().cpu().numpy(), v.float().cpu().numpy(),
                             off.cpu().numpy(), kl.cpu().numpy(), window,
                             sq=q.shape[1]))
    poisoned = ops.flash_attention_cached(q, pk, pv, q_offset=off, kv_len=kl,
                                          window=window)
    torch.cuda.synchronize()
    _assert_close_slots(got, want, tol)
    assert blind and all(torch.all(got[i] == 0) for i in blind)
    assert torch.equal(got, again)
    assert torch.equal(poisoned, got)
