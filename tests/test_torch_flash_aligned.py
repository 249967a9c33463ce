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


BF16_RMS_TOL = 0.1  # chip_smoke.py's ALIGNED_RMS_TOL


def _assert_close(got, want, tol):
    """Every element within ``atol + tol |want|``: atol = tol in float32;
    in bf16 the smaller of tol and 0.1 rms(want), since an attention
    output's typical value shrinks as 1 / sqrt(visible keys) and a fixed
    3e-2 would pass a dropped or unmasked kv tile at long sequences
    (``test_cuda_bf16_gate_rejects_planted_faults``)."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    rms = float(np.sqrt(np.mean(want ** 2)))
    atol = min(tol, BF16_RMS_TOL * rms) if bf16 else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


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
    the 64-row tile, head dims on the wgmma path (bf16 64 and 128) and on
    the FMA path (f32, and bf16 16, 32, 208, 256)."""
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
    _assert_close(got, want, tol)


# ---------------------------------------------------------------------------
# The Hopper (TMA + wgmma) path: its schedule on the CPU, its kernel on a card
# ---------------------------------------------------------------------------

def _visible(q, k, sk, causal, window):
    ok = k < sk
    if causal:
        ok = ok and k <= q
    if window > 0:
        ok = ok and k > q - window
    return ok


SCHEDULE_CASES = [  # (B, Sq, Sk, Hq, causal, window)
    (1, 4096, 4096, 12, True, 0),     # qwen2-1.5b's prefill width
    (1, 8192, 8192, 32, True, 4096),  # mixtral-8x7b's window
    (1, 200, 150, 4, True, 0),        # Sk < Sq, neither a multiple of 128
    (1, 150, 333, 4, False, 0),       # Sk > Sq, not causal
    (2, 300, 200, 2, True, 7),        # a window smaller than a tile
    (1, 130, 130, 2, True, 5),
]


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_wgmma_schedule_covers_the_band_and_masks_exactly(case):
    """Every visible (query, key) pair lies in a kv tile of its query
    tile's band, every tile of a band holds a visible pair, and a tile
    skips the mask exactly when all its pairs (the padding rows of the
    last query tile included) are visible."""
    b, sq, sk, hq, causal, window = case
    sched = FA.wgmma_schedule(b, sq, sk, hq, causal=causal, window=window)
    assert sched["grid"] == (hq * b, -(-sq // FA.WG_BM))
    assert sched["threads"] == FA.WG_THREADS == 3 * 128
    q0s = sorted(o["q0"] for o in sched["order"])
    assert q0s == list(range(0, sq, FA.WG_BM))
    step = 16 if sq > 1000 else 1  # sample rows and keys on the long cases
    for o in sched["order"]:
        q0, tiles = o["q0"], o["tiles"]
        starts = [kt for kt, _ in tiles]
        assert starts == list(range(starts[0], starts[0] + FA.WG_BN * len(
            starts), FA.WG_BN)) if starts else True
        rows = range(q0, min(q0 + FA.WG_BM, sq))
        covered = set()
        for kt, masked in tiles:
            keys = range(kt, kt + FA.WG_BN)
            assert any(_visible(q, k, sk, causal, window)
                       for q in rows for k in keys)
            hidden = any(not _visible(q, k, sk, causal, window)
                         for q in range(q0, q0 + FA.WG_BM, step)
                         for k in keys) or not all(
                _visible(q, k, sk, causal, window)
                for q in (q0, q0 + FA.WG_BM - 1) for k in (kt, kt + FA.WG_BN - 1))
            assert masked == hidden, (q0, kt)
            covered.update(keys)
        for q in rows[::step]:
            for k in range(0, sk, step):
                if _visible(q, k, sk, causal, window):
                    assert k in covered, (q, k)


def test_wgmma_schedule_launches_the_longest_bands_first():
    """Causal: blockIdx.y 0 owns the last query tile, and the number of kv
    tiles never grows along the launch order; at qwen2-1.5b's prefill one
    tile a band is masked (the diagonal) and the rest skip the mask."""
    sched = FA.wgmma_schedule(1, 4096, 4096, 12, causal=True)
    counts = [len(o["tiles"]) for o in sched["order"]]
    assert counts == sorted(counts, reverse=True) and counts[0] == 32
    assert sched["order"][0]["q0"] == 4096 - FA.WG_BM
    assert all(sum(m for _, m in o["tiles"]) == 1 for o in sched["order"])
    win = FA.wgmma_schedule(1, 8192, 8192, 32, causal=True, window=4096)
    masked = [sum(m for _, m in o["tiles"]) for o in win["order"]]
    assert set(masked) == {1, 2} and sum(masked) == 96


def test_wgmma_shared_memory_fits_a_cta():
    """Q, two K and two V stages, the barriers and the alignment slack:
    160 KB at D 128, within the 227 KB a CTA can have."""
    assert FA.wgmma_smem(128) == 128 * 128 * 2 * 5 + 72 + 1024 == 164936
    assert FA.wgmma_smem(64) == 83016
    assert FA.wgmma_smem(128) <= 232448


WGMMA_CARD = [  # (B, Sq, Sk, Hq, Hkv, D, causal, window)
    (1, 4096, 4096, 12, 2, 128, True, 0),
    (1, 2048, 2048, 8, 2, 64, True, 0),
    (1, 200, 150, 4, 2, 64, True, 0),
    (1, 200, 150, 4, 2, 128, True, 0),
    (1, 150, 333, 4, 2, 128, False, 0),
    (1, 150, 333, 4, 2, 64, True, 0),
    (2, 130, 130, 2, 1, 64, True, 5),
    (2, 300, 200, 2, 1, 128, True, 7),
    (2, 256, 256, 2, 2, 128, False, 0),
    (1, 1024, 1024, 8, 8, 64, True, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CARD, ids=lambda c: "-".join(
    str(x) for x in c))
def test_cuda_wgmma_path_matches_plain(cuda_device, case):
    """D 64 and 128, Sq and Sk not multiples of 128 both ways, a window
    smaller than a tile, not causal, rows that see no key (Sk < Sq with a
    window: 0), and two runs bit-equal; the launch is the wgmma kernel's."""
    b, sq, sk, hq, hkv, d, causal, window = case
    cfg = dict(b=b, s=sq, hq=hq, hkv=hkv, d=d)
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(cfg, sk=sk))
    p = FA.plan(b, sq, sk, hq, hkv, d, torch.bfloat16)
    assert (p["threads"], p["stages"], p["smem_bytes"]) == (
        FA.WG_THREADS, FA.WG_STAGES, FA.wgmma_smem(d))
    assert p["CTAs"] == hq * b * -(-sq // FA.WG_BM)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_close(got, want, 3e-2)
    assert torch.equal(got, again)
    if window and sk < sq:
        blind = [i for i in range(sq) if i - window + 1 >= sk]
        assert blind and got[:, blind].abs().max().item() == 0.0


def test_bf16_gate_sees_a_dropped_kv_tile_or_an_unmasked_diagonal():
    """The CPU twin of the planted-fault card test, on the plain version
    at S 8192, D 128: the last 128 query rows computed without one
    128-key tile of their 64-tile band, or with the keys past the diagonal
    visible, fail the bf16 gate (a fixed 3e-2 would pass both); the
    output's own bf16 rounding passes."""
    s, r0 = 8192, 8192 - 128
    q, k, v = (torch.from_numpy(a).bfloat16().float()
               for a in _qkv(dict(b=1, s=s, hq=1, hkv=1, d=128)))
    rows, keys = torch.arange(r0, s)[:, None], torch.arange(s)[None]
    exact = flash_attention_ref(q, k, v, causal=True)
    _assert_close(exact.bfloat16(), exact, 3e-2)
    causal = keys <= rows
    for mask in (causal & ((keys < 4096) | (keys >= 4096 + 128)),
                 torch.ones_like(causal)):
        scores = torch.einsum("qd,kd->qk", q[0, r0:, 0], k[0, :, 0])
        p = torch.softmax(scores.masked_fill(~mask, -torch.inf) / 128 ** 0.5,
                          dim=-1)
        bad = exact.clone()
        bad[0, r0:, 0] = p @ v[0, :, 0]
        bad = bad.bfloat16()
        np.testing.assert_allclose(bad.float().numpy(), exact.numpy(),
                                   rtol=3e-2, atol=3e-2)
        with pytest.raises(AssertionError):
            _assert_close(bad, exact, 3e-2)


# a statement of the wgmma consumer -> the same statement with a fault
FAULTS = {
    "diagonal tile unmasked": (
        "visible((j & 2) ? rb : ra, kpos, Sk, causal, window)",
        "visible((j & 2) ? rb : ra, kpos, Sk, 0, window)"),
    "one kv tile of a 32-tile band dropped": (
        "mbar_arrive(&k_empty[s]);",
        "mbar_arrive(&k_empty[s]);\n"
        "      if (n >= 32 && i == n / 2)\n"
        "        for (int j = 0; j < BN / 2; ++j) sc[j] = -INFINITY;"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(FAULTS))
def test_cuda_bf16_gate_rejects_planted_faults(cuda_device, tmp_path, fault):
    """The bf16 gate sees a wrong mask or a missing kv tile at qwen2-1.5b's
    prefill width: a copy of the source with one fault planted in the
    wgmma consumer, built into tmp_path, fails it where the real kernel
    passes."""
    import ctypes
    import subprocess

    from repro_torch.kernels import build

    old, new = FAULTS[fault]
    src = (build.CSRC / "flash_aligned.cu").read_text()
    assert src.count(old) == 1
    cu, lib = tmp_path / "fault.cu", tmp_path / "libfault.so"
    cu.write_text(src.replace(old, new))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(cu)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).flash_aligned_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cfg = dict(b=1, s=4096, hq=12, hkv=2, d=128)
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(cfg))
    want = flash_attention_ref(q, k, v, causal=True)
    _assert_close(ops.flash_attention(q, k, v, causal=True), want, 3e-2)
    bad = torch.empty_like(q)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bad.data_ptr(), 1,
              4096, 4096, 12, 2, 128, 1, 0, 1,
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        _assert_close(bad, want, 3e-2)
