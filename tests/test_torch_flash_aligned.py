"""The port's aligned flash attention (kernel 3) against the JAX package's
Pallas kernel (interpret mode on the CPU) at the configs of
``tests/test_kernels.py``'s ``TestFlashAttention``, its wrapper checks,
and, on a card, the CUDA kernel against its plain version.

JAX is imported inside the reference fixture only, so that the card's
tests run on a machine without it:
``python -m pytest -q -m cuda tests/test_torch_flash_aligned.py``."""
import math

import numpy as np
import pytest
import torch
from test_torch_ssd_scan import tf32_round

from repro_torch.kernels import flash_aligned as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from torch_devices import elsewhere

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
    q, k, v = (elsewhere(torch.from_numpy(a))
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


BF16_RMS_TOL = 0.1  # chip_smoke.py's BF16_RMS_TOL


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
    dict(b=1, s=300, hq=4, hkv=2, d=160, causal=True, window=0, sk=200),
    dict(b=2, s=130, hq=2, hkv=1, d=192, causal=True, window=5),
    dict(b=1, s=150, hq=4, hkv=2, d=256, causal=False, window=0, sk=333),
    dict(b=1, s=100, hq=2, hkv=1, d=144, causal=True, window=0),
])
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype, tol):
    """Causal, full, GQA/MQA, Sk != Sq both ways, a window smaller than
    the 64-row tile, every path: f32 on TF32 tensor cores at every head
    dim, bf16 on wgmma (64, 128, and 144 .. 256 padded to whole 64-column
    boxes) and on the FMA loops (16, 32)."""
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


@pytest.mark.parametrize("d, dp, bn, smem", [
    (144, 192, 64, 148552), (160, 192, 64, 148552), (192, 192, 64, 148552),
    (208, 256, 64, 197704), (256, 256, 64, 197704),
])
def test_wgmma_tiles_past_d128_fit_a_cta(d, dp, bn, smem):
    """A head dim past 128 is padded to whole 64-column boxes and takes
    64-row kv tiles: Q (128 x DP) and two K and two V stages (64 x DP) in
    bf16 fit the 227 KB a CTA can have, and the accumulators (64 x DP
    output, 64 x 64 scores, a warpgroup) fit 240 registers a thread."""
    t = FA.wgmma_tiles(d)
    assert (t["dp"], t["bn"], t["cw"]) == (dp, bn, 64)
    assert FA.wgmma_smem(d) == 128 * dp * 2 + 4 * 64 * dp * 2 + 72 + 1024
    assert FA.wgmma_smem(d) == smem <= 232448
    regs = dp // 2 + bn // 2 + bn // 16 * 4  # O, S, P fragments a thread
    assert regs <= 176 < 240
    assert FA.path(d, torch.bfloat16) == "wgmma"
    assert FA.path(d, torch.float32) == "tf32"


@pytest.mark.parametrize("d", [64, 128, 144, 160, 176, 192, 208, 224, 240, 256])
def test_wgmma_epilogue_stores_each_true_column_once(d):
    """The consumer's epilogue writes columns c CW + 8 (j / 4) + 2 t and
    the next one for every output chunk c, accumulator group j and quad
    lane t, skipping col >= D: every column of the true head dim exactly
    once, and no zero-filled padding column."""
    t = FA.wgmma_tiles(d)
    cols = []
    for c in range(t["dp"] // t["cw"]):
        for j in range(0, t["cw"] // 2, 4):
            for lane in range(4):
                col = c * t["cw"] + (j // 4) * 8 + 2 * lane
                if col < d:
                    cols += [col, col + 1]
    assert sorted(cols) == list(range(d))


def test_padding_columns_add_nothing():
    """Zero Q/K columns past D add nothing to Q K^T and zero V columns give
    zero output columns: attention over operands padded from 160 to 192
    columns (scale 1/sqrt(160)) equals the unpadded attention in its first
    160 columns, bit for bit in float64."""
    cfg = dict(b=1, s=40, hq=2, hkv=1, d=160)
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(cfg, seed=3))
    pad = [torch.nn.functional.pad(x, (0, 32)) for x in (q, k, v)]
    for causal, window in ((True, 0), (False, 0), (True, 9)):
        want = _oracle(q, k, v, causal=causal, window=window)
        got = _oracle(*pad, causal=causal, window=window, d=160)
        assert torch.equal(got[..., :160], want)
        assert torch.equal(got[..., 160:], torch.zeros_like(got[..., 160:]))


# ---------------------------------------------------------------------------
# The float32 path: TF32 tensor cores with split operands (3xTF32)
# ---------------------------------------------------------------------------

def _oracle(q, k, v, *, causal, window, d=None):
    """Attention in float64 with the kernel's contract: scale 1/sqrt(d)
    (the head dim unless given), rows that see no key give 0."""
    q, k, v = q.double(), k.double(), v.double()
    sq, hq, d_ = q.shape[1:]
    sk, hkv = k.shape[1:3]
    kf, vf = (x.repeat_interleave(hq // hkv, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) / math.sqrt(d or d_)
    qp, kp = torch.arange(sq)[:, None], torch.arange(sk)[None]
    vis = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        vis &= kp <= qp
    if window:
        vis &= kp > qp - window
    p = torch.softmax(s.masked_fill(~vis, -math.inf), -1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf)


def tf32_trunc(t: torch.Tensor) -> torch.Tensor:
    """float32 with its low 13 mantissa bits cleared: the kernel's TF32
    head, and what the tensor core reads of a residual handed over raw."""
    return (t.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def _mm_tf32(a, b, products):
    """a @ b as the kernel's mma3 sums it: each operand split into its TF32
    truncation and the truncation of the (exact) residual, al bh + ah bl +
    ah bh (products of TF32 values are exact in float32); ``products`` 1:
    one product of operands rounded to their nearest TF32 values, the best
    one product can do."""
    if products == 1:
        return tf32_round(a) @ tf32_round(b)
    ah, bh = tf32_trunc(a), tf32_trunc(b)
    return tf32_trunc(a - ah) @ bh + ah @ tf32_trunc(b - bh) + ah @ bh


def tf32_model(q, k, v, *, causal, window, products=3):
    """Kernel 3's float32 path in plain torch on float32 values: kv tiles of
    ``FA.TF_BN`` keys (zero rows past Sk, masked to -inf), the online
    softmax in base 2 with m from -1e30, S = Q K^T and O += P V through
    ``_mm_tf32``.  Processing every tile, where the kernel skips those no
    row of its query tile can see, changes no bit: such a tile leaves m,
    l and the accumulator exactly as they were."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1:3]
    sl2 = math.log2(math.e) / math.sqrt(d)
    bn = FA.TF_BN
    out = torch.zeros((b, sq, hq, d))
    qp = torch.arange(sq)[:, None]
    for bi in range(b):
        for h in range(hq):
            kh = h // (hq // hkv)
            m = torch.full((sq, 1), -1e30)
            l, acc = torch.zeros((sq, 1)), torch.zeros((sq, d))
            for kt in range(0, sk, bn):
                kp = torch.arange(kt, kt + bn)[None]
                kt_, vt_ = torch.zeros((bn, d)), torch.zeros((bn, d))
                n = min(bn, sk - kt)
                kt_[:n], vt_[:n] = k[bi, kt:kt + n, kh], v[bi, kt:kt + n, kh]
                s = _mm_tf32(q[bi, :, h].float(), kt_.T, products)
                vis = kp < sk
                if causal:
                    vis = vis & (kp <= qp)
                if window:
                    vis = vis & (kp > qp - window)
                s = torch.where(vis, s, -math.inf)
                mn = torch.maximum(m, s.amax(1, keepdim=True) * sl2)
                corr = torch.exp2(m - mn)
                p = torch.exp2(s * sl2 - mn)
                l = l * corr + p.sum(1, keepdim=True)
                acc = acc * corr + _mm_tf32(p, vt_, products)
                m = mn
            out[bi, :, h] = acc / l.clamp_min(1e-30)
    return out


TF32_CASES = [  # (B, Sq, Sk, Hq, Hkv, D, causal, window)
    (1, 96, 96, 2, 1, 32, True, 0),
    (1, 80, 80, 2, 2, 16, True, 7),     # a window smaller than a tile
    (1, 70, 45, 2, 1, 48, True, 0),     # Sk < Sq: rows past Sk see all
    (1, 40, 100, 2, 2, 64, False, 0),   # Sk > Sq, not causal
    (1, 60, 20, 2, 1, 16, True, 5),     # rows that see no key give 0
    (1, 128, 128, 1, 1, 256, True, 0),
]


@pytest.mark.parametrize("case", TF32_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_tf32_split_products_hold_1e4(case):
    """Three TF32 products of split operands hold the float32 gate, 1e-4
    absolute plus 1e-4 |want|, against the float64 oracle (the kernel's
    error is then the tensor cores' float32 sums, not its operands')."""
    b, sq, sk, hq, hkv, d, causal, window = case
    q, k, v = (torch.from_numpy(a) for a in _qkv(
        dict(b=b, s=sq, hq=hq, hkv=hkv, d=d), seed=4, sk=sk))
    want = _oracle(q, k, v, causal=causal, window=window)
    got = tf32_model(q, k, v, causal=causal, window=window).double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    if window and sk < sq:
        blind = [i for i in range(sq) if i - window + 1 >= sk]
        assert blind and got[:, blind].abs().max().item() == 0.0


def test_one_tf32_product_misses_1e4():
    """Why three: one product of operands rounded to TF32 misses the gate
    at the bench's head dim."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(
        dict(b=1, s=256, hq=2, hkv=1, d=128), seed=4))
    want = _oracle(q, k, v, causal=True, window=0).numpy()
    got = tf32_model(q, k, v, causal=True, window=0, products=1)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("d, smem", [(16, 17408), (128, 103424),
                                     (256, 201728)])
def test_tf32_shared_memory_fits_a_cta(d, smem):
    """Q (64 rows) and two (K, V) stages of 32 rows in float32 rows of
    D + 8 words (Q, K) and D + 4 (V): two CTAs an SM at D 128, one at
    D 256."""
    assert FA.tf32_smem(d) == smem <= 232448
    assert (2 * FA.tf32_smem(128) <= 233472) and 2 * FA.tf32_smem(256) > 233472


@pytest.mark.parametrize("case", SCHEDULE_CASES[:4], ids=lambda c: "-".join(
    str(x) for x in c))
def test_tf32_schedule_covers_the_band(case):
    """The float32 path's 64-row query tiles and 32-row kv tiles: every
    visible pair in a tile of its band, every tile of a band holding one,
    the longest bands first."""
    b, sq, sk, hq, causal, window = case
    sched = FA.tf32_schedule(b, sq, sk, hq, causal=causal, window=window)
    assert sched["grid"] == (hq * b, -(-sq // FA.TF_BM))
    assert sched["bn"] == FA.TF_BN and sched["threads"] == 128
    step = 16 if sq > 1000 else 1
    counts = []
    for o in sched["order"]:
        rows = range(o["q0"], min(o["q0"] + FA.TF_BM, sq))
        covered = set()
        for kt, _ in o["tiles"]:
            keys = range(kt, kt + FA.TF_BN)
            assert any(_visible(q, k_, sk, causal, window)
                       for q in rows[::step] for k_ in keys) or step > 1
            covered.update(keys)
        for q in rows[::step]:
            for k_ in range(0, sk, step):
                if _visible(q, k_, sk, causal, window):
                    assert k_ in covered
        counts.append(len(o["tiles"]))
    if causal and not window:
        assert counts == sorted(counts, reverse=True)


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
    (1, 4096, 4096, 8, 1, 256, True, 0),    # gemma-2b's prefill width
    (1, 1024, 1024, 32, 8, 160, True, 0),   # stablelm-12b's, shorter
    (1, 200, 150, 4, 2, 192, True, 0),
    (2, 300, 200, 2, 1, 256, True, 7),
    (1, 150, 333, 4, 2, 160, False, 0),
    (2, 130, 130, 2, 1, 224, True, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CARD, ids=lambda c: "-".join(
    str(x) for x in c))
def test_cuda_wgmma_path_matches_plain(cuda_device, case):
    """D 64 and 128, and 160 to 256 padded to whole 64-column boxes, Sq
    and Sk not multiples of 128 both ways, a window smaller than a tile,
    not causal, rows that see no key (Sk < Sq with a window: 0), and two
    runs bit-equal; the launch is the wgmma kernel's."""
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


TF32_CARD = [  # (B, Sq, Sk, Hq, Hkv, D, causal, window)
    (2, 2048, 2048, 8, 2, 128, True, 0),   # the reference bench's full row
    (1, 512, 512, 4, 2, 64, True, 0),      # and its quick row
    (1, 300, 200, 4, 2, 160, True, 7),
    (1, 150, 333, 2, 1, 256, False, 0),
    (2, 130, 130, 2, 1, 16, True, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TF32_CARD, ids=lambda c: "-".join(
    str(x) for x in c))
def test_cuda_tf32_path_matches_plain(cuda_device, case):
    """float32 on TF32 tensor cores with split operands: the unchanged
    1e-4 gate against the plain version (TF32 off), rows that see no key
    give 0, two runs bit-equal, the launch as the host-side model has it."""
    b, sq, sk, hq, hkv, d, causal, window = case
    cfg = dict(b=b, s=sq, hq=hq, hkv=hkv, d=d)
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(cfg, sk=sk))
    p = FA.plan(b, sq, sk, hq, hkv, d, torch.float32)
    assert (p["threads"], p["stages"], p["smem_bytes"]) == (
        FA.TF_THREADS, FA.TF_STAGES, FA.tf32_smem(d))
    assert p["CTAs"] == hq * b * -(-sq // FA.TF_BM)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _assert_close(got, want, 1e-4)
    assert torch.equal(got, again)
    if window and sk < sq:
        blind = [i for i in range(sq) if i - window + 1 >= sk]
        assert blind and got[:, blind].abs().max().item() == 0.0
