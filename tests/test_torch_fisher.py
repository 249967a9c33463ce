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
from torch_devices import elsewhere

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
    g = elsewhere(torch.zeros(2, 3, 4))
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
@pytest.mark.parametrize("shape", [(4, 28, 48, 8960), (3, 28, 48, 12),
                                   (2, 4, 3, 77), (1, 28, 48, 8960)])
def test_cuda_task_axis_matches_plain_and_one_task_launches(cuda_device,
                                                            shape, dtype):
    """The task axis (a fleet's probe): one launch over (T, L, B, C) with a
    ragged (T, B) mask (NaN in the masked rows) and (T,) counts on the
    card, within tolerance of the plain version, each task bit-equal to a
    one-task launch on its slice, and the launch held to ``rows_plan``."""
    t, layers, b, c = shape
    g = _t(_normal(shape, 0), dtype).to(cuda_device)
    mask = torch.stack([_valid_mask(b, max(1, b - 2 * i))
                        for i in range(t)]).to(cuda_device)
    g[(mask == 0)[:, None, :, None].expand_as(g)] = float("nan")
    n = mask.sum(1)
    n0 = ops.fisher_tapgrads.launches
    got = ops.fisher_tapgrads(g, n, mask)
    assert ops.fisher_tapgrads.launches == n0 + 1
    want = fisher_tapgrads_ref(g, n, mask)
    ones = [ops.fisher_tapgrads(g[i].contiguous(), float(n[i]),
                                mask[i].contiguous()) for i in range(t)]
    torch.cuda.synchronize()
    assert got.shape == (t, layers, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert all(torch.equal(got[i], ones[i]) for i in range(t))
    plan = FK.plan(g)
    model = FK.rows_plan(layers, b, c, g.dtype, tasks=t)
    assert all(plan[k] == model[k] for k in (*FK.PLAN_KEYS, "tasks"))


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


# ---------------------------------------------------------------------------
# The tap-gradient route's launch (csrc/fisher.cu, fisher_rows_kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, dtype, aligned, vec", [
    ((28, 48, 8960), torch.float32, True, 4),    # qwen2-1.5b's d_ff group
    ((28, 48, 12), torch.float32, True, 4),      # its heads group
    ((28, 48, 8960), torch.bfloat16, True, 8),
    ((28, 48, 12), torch.bfloat16, True, 1),     # 12 columns: no 8-wide load
    ((4, 3, 77), torch.float32, True, 1),        # ragged
    ((48, 48, 64), torch.float32, False, 1),     # an unaligned operand
])
def test_rows_plan_covers_every_column_once(shape, dtype, aligned, vec):
    """Every (layer, column) belongs to exactly one thread's VEC
    neighbouring columns; threads past the last own nothing; the grid is
    whole blocks of 128."""
    layers, n, c = shape
    plan = FK.rows_plan(layers, n, c, dtype, aligned)
    assert plan["vec"] == vec == FK.rows_vec(c, dtype, aligned)
    assert plan["threads"] == FK.RT and plan["blocks"] == -(
        -layers * (c // vec) // FK.RT)
    seen = np.zeros((layers, c), np.int64)
    for blk in range(plan["blocks"]):
        for th in range(plan["threads"]):
            own = plan["owner"](blk, th)
            if own is None:
                assert blk * FK.RT + th >= layers * c // vec
                continue
            lyr, c0 = own
            assert c0 % vec == 0
            seen[lyr, c0:c0 + vec] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n, seed", [(48, 0), (3, 1), (2500, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_compacted_rows_are_the_mask_nonzero_rows(n, seed, masked):
    """The rows the kernel reads, pass by pass (1024 a pass), are exactly
    the mask's non-zero rows in order, each weighted m^2; without a mask
    every row with weight 1."""
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(np.where(rng.random(n) < 0.3, 0.0,
                                     rng.random(n) + 0.5).astype(np.float32)
                            ) if masked else None
    passes = FK.compact_rows(mask, n)
    assert len(passes) == -(-n // FK.RCH)
    rows = [r for rs, _ in passes for r in rs]
    weights = [w for _, ws in passes for w in ws]
    want = (torch.nonzero(mask).flatten().tolist() if masked
            else list(range(n)))
    assert rows == want
    np.testing.assert_allclose(
        weights, [1.0] * n if not masked else (mask[want] ** 2).tolist(),
        rtol=1e-6)
    for i, (rs, _) in enumerate(passes):
        assert all(i * FK.RCH <= r < (i + 1) * FK.RCH for r in rs)


def test_rows_model_matches_plain():
    """The kernel's sum over its compacted rows, for each owned column in
    row order (scale x sum w g^2), is the plain version's Eq. 2; NaN in the
    masked rows is never read."""
    g = torch.from_numpy(_normal((3, 40, 24), 7))
    mask = (torch.arange(40) % 5 != 0).float()
    g[:, mask == 0] = float("nan")
    n = float(mask.sum())
    plan = FK.rows_plan(3, 40, 24, torch.float32)
    got = torch.zeros(3, 24)
    (rows, weights), = FK.compact_rows(mask, 40)
    for blk in range(plan["blocks"]):
        for th in range(plan["threads"]):
            own = plan["owner"](blk, th)
            if own is None:
                continue
            lyr, c0 = own
            acc = torch.zeros(plan["vec"])
            for r, w in zip(rows, weights):
                acc += w * g[lyr, r, c0:c0 + plan["vec"]] ** 2
            got[lyr, c0:c0 + plan["vec"]] = acc / (2.0 * n)
    want = fisher_tapgrads_ref(g, n, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype, offset", [
    ((28, 48, 8960), torch.float32, 0),
    ((28, 48, 12), torch.float32, 0),
    ((28, 48, 8960), torch.bfloat16, 0),
    ((28, 48, 12), torch.bfloat16, 0),
    ((4, 3, 77), torch.float32, 0),
    ((6, 48, 64), torch.float32, 1),  # g starts 4 bytes past a boundary
])
def test_cuda_tapgrads_launch_matches_model(cuda_device, shape, dtype,
                                            offset):
    """The launch the kernel makes (``fisher_tapgrads_fwd``'s plan, one
    task) is the host-side model's, 16-byte loads where the shape and
    alignment allow them; the result matches the plain version either
    way."""
    numel = int(np.prod(shape))
    buf = _t(_normal((numel + offset,), 3), "float32").to(cuda_device, dtype)
    g = buf[offset:].view(shape)
    plan = FK.plan(g[None])
    model = FK.rows_plan(*shape, dtype, aligned=g.data_ptr() % 16 == 0)
    assert plan == {**{k: model[k] for k in FK.PLAN_KEYS}, "tasks": 1}
    mask = _valid_mask(shape[1], shape[1] - 1).to(cuda_device)
    got = ops.fisher_tapgrads(g, float(shape[1] - 1), mask)
    want = fisher_tapgrads_ref(g, float(shape[1] - 1), mask)
    torch.cuda.synchronize()
    tol = TOL[str(dtype).split(".")[-1]]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tapgrads_over_many_passes(cuda_device, dtype):
    """2,500 rows (three compaction passes of 1,024), a third of them
    masked and holding NaN: never read, the plain version's result."""
    shape = (3, 2500, 136)
    g = _t(_normal(shape, 5), dtype).to(cuda_device)
    keep = torch.from_numpy(np.random.default_rng(6).random(2500) > 0.33)
    mask = keep.float().to(cuda_device)
    g[:, ~keep.to(cuda_device)] = float("nan")
    got = ops.fisher_tapgrads(g, float(keep.sum()), mask)
    want = fisher_tapgrads_ref(g, float(keep.sum()), mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# The (N, D, C) kernel's launch (csrc/fisher.cu, fisher_general_kernel)
# ---------------------------------------------------------------------------

# (N, D, C): the kernel bench's row, qwen2-1.5b's d_ff over an episode of
# 48 rows of 64 tokens, an edge CNN's first layer at 84 px (64 support
# images, a 42 x 42 map, 8 channels) and a late depthwise layer of
# mcunet-5fps (576 channels at 3 x 3)
GENERAL_SHAPES = {"bench": (16, 2048, 1024), "wide": (48, 64, 8960),
                  "cnn-early": (64, 1764, 8), "cnn-head": (64, 9, 576)}


def _mask_with_holes(n, seed):
    """A (N,) mask with zero rows (a third, at least one) and weights
    other than 1."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random(n) < 0.33, 0.0, rng.random(n) + 0.5)
    m[n // 2] = 0.0
    return torch.from_numpy(m.astype(np.float32))


@pytest.mark.parametrize("shape, dtype, aligned", [
    (GENERAL_SHAPES["bench"], torch.float32, True),
    (GENERAL_SHAPES["bench"], torch.bfloat16, True),
    (GENERAL_SHAPES["wide"], torch.float32, True),
    (GENERAL_SHAPES["wide"], torch.bfloat16, True),
    (GENERAL_SHAPES["cnn-early"], torch.float32, True),
    (GENERAL_SHAPES["cnn-head"], torch.float32, True),
    ((6, 7, 77), torch.float32, True),           # ragged D and C
    ((5, 3, 300), torch.bfloat16, True),         # 300 columns: no 8-wide load
    ((300, 5, 12), torch.float32, True),         # two compaction passes
    ((4, 1024, 512), torch.float32, False),      # an unaligned operand
])
def test_general_plan_reads_every_valid_element_once(shape, dtype, aligned):
    """Over the whole launch, every (n, d, c) of a valid row is read by
    exactly one thread and no masked row is read at all."""
    n, d, c = shape
    plan = FK.general_plan(n, d, c, dtype, aligned)
    mask = _mask_with_holes(n, 3)
    (rows,) = [sum((rs for rs, _ in FK.compact_rows(mask, n, FK.GCH)), [])]
    assert rows == torch.nonzero(mask).flatten().tolist()
    seen = np.zeros(shape, np.int8)
    for blk in range(plan["blocks"]):
        for th in range(plan["threads_x"] * plan["threads_y"]):
            rs, ds, cs = plan["reads"](blk, th, rows)
            if rs and ds and cs:
                seen[np.ix_(rs, ds, cs)] += 1
    valid = mask.numpy() != 0
    assert (seen[valid] == 1).all()
    assert (seen[~valid] == 0).all()
    assert plan["vec"] == FK.rows_vec(c, dtype, aligned)
    assert plan["cluster"] == plan["d_ranks"] * plan["row_ranks"] <= 8
    assert plan["blocks"] % plan["cluster"] == 0


@pytest.mark.parametrize("name", list(GENERAL_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_general_grid_fills_the_card(name, dtype):
    """At least one wave of the 132 SMs at the bench's and the wide shape;
    at the edge CNNs' narrow shapes, more than the first design's CTAs
    (one, and 18), by splitting the rows across the cluster."""
    n, d, c = GENERAL_SHAPES[name]
    plan = FK.general_plan(n, d, c, dtype)
    threads = plan["threads_x"] * plan["threads_y"]
    assert 32 <= threads <= FK.GT and threads % 32 == 0
    if name in ("bench", "wide"):
        assert plan["blocks"] >= FK.GWAVE
    else:
        first = -(-c // 32)
        assert plan["blocks"] > first and plan["cluster"] == 8
    # the rows are split first, a whole chunk of rows a rank; d where the
    # rows run out (the bench's 16 rows) and d is long
    rows_enough = n >= plan["cluster"] * plan["rows_a_chunk"]
    assert (plan["d_ranks"] == 1) == rows_enough


def _general_model(a, g, mask, scale, mask_norm):
    """``fisher_general_kernel`` emulated CTA by CTA in float32: each
    thread's sum over its d values, the d lanes' partials summed in lane
    order through the kernel's shared-memory layout (R threads an entry,
    then their butterfly), u over the D-ranks in rank order, the square
    weighted by m^2 into each thread's accumulator, and at the end the
    CTA's row slots in order and the cluster's ranks in rank order."""
    n, d, c = a.shape
    p = FK.general_plan(n, d, c, a.dtype)
    S, sd, sn = p["cluster"], p["d_ranks"], p["row_ranks"]
    TX, TY, VEC, NB = (p["threads_x"], p["threads_y"], p["vec"],
                       p["rows_a_chunk"])
    R, dc = p["reducers"], p["d_chunk"]
    NT, CT = TX * TY, TX * VEC
    LDP, slots, per = NB * CT + 4, NT // (R * CT), TY // R
    t = np.arange(NT)
    e0, r = t // R, t % R
    col, js = e0 % CT, e0 // CT
    a32, g32 = a.float().numpy(), g.float().numpy()
    passes = FK.compact_rows(mask, n, FK.GCH)
    msum = np.float32(0.0 if mask is None else mask.sum().item())
    sc = np.float32(scale / max(msum, 1.0) if mask_norm else scale)
    out = np.zeros(c, np.float32)
    for tile in range(p["tiles"]):
        acc = np.zeros((S, NT), np.float32)
        s_u = np.zeros((S, 2, 16 * 32), np.float32)
        buf = 0
        for rows, weights in passes:
            cnt = len(rows)
            nch = -(-(-(-cnt // sn)) // NB)
            for ch in range(nch):
                for rank in range(S):
                    rn, rd = divmod(rank, sd)
                    k0 = rn + sn * ch * NB
                    nv = min(NB, -(-(cnt - k0) // sn)) if k0 < cnt else 0
                    s_part = np.zeros(FK.GT * 20, np.float32)
                    cols = tile * CT + np.arange(CT)
                    live = cols < c
                    for ty in range(TY):
                        for i in range(nv):
                            row = rows[k0 + sn * i]
                            pv = np.zeros(CT, np.float32)
                            for dd in range(rd * dc + ty,
                                            min(d, rd * dc + dc), TY):
                                pv[live] += (a32[row, dd, cols[live]]
                                             * g32[row, dd, cols[live]])
                            s_part[ty * LDP + i * CT:
                                   ty * LDP + (i + 1) * CT] = pv
                    for j0 in range(NB):
                        sel = js == j0 % slots  # rows js, js + slots, ...
                        u = np.zeros(NT, np.float32)
                        for k in range(per):
                            u += s_part[(r * per + k) * LDP + j0 * CT + col]
                        o = R // 2
                        while o:
                            u = u + u[t ^ o]
                            o //= 2
                        own = sel & (r == 0)
                        if sd == 1:
                            if j0 < nv:
                                w = np.float32(weights[k0 + sn * j0])
                                acc[rank, own] += w * (u[own] * u[own])
                        else:
                            s_u[rank, buf, j0 * CT + col[own]] = u[own]
                if sd > 1:
                    for rank in range(S):
                        rn, rd = divmod(rank, sd)
                        k0 = rn + sn * ch * NB
                        nv = min(NB, -(-(cnt - k0) // sn)) if k0 < cnt else 0
                        for j0 in range(rd, nv, sd):
                            own = (js == j0 % slots) & (r == 0)
                            u = np.zeros(own.sum(), np.float32)
                            for q in range(sd):
                                u += s_u[rn * sd + q, buf, j0 * CT + col[own]]
                            w = np.float32(weights[k0 + sn * j0])
                            acc[rank, own] += w * (u * u)
                    buf ^= 1
        fin = np.zeros((S, CT), np.float32)
        for rank in range(S):
            part = np.zeros(NT, np.float32)
            own = r == 0
            part[js[own] * CT + col[own]] = acc[rank, own]
            for q in range(slots):
                fin[rank] += part[q * CT:(q + 1) * CT]
        tot = np.zeros(CT, np.float32)
        for q in range(S):
            tot += fin[q]
        cols = tile * CT + np.arange(CT)
        out[cols[cols < c]] = (tot * sc)[cols < c]
    return torch.from_numpy(out)


@pytest.mark.parametrize("shape, dtype", [
    ((6, 7, 77), torch.float32),       # row-ranks, scalar columns
    ((5, 3, 300), torch.float32),      # 16-byte loads, d lanes past D
    ((3, 1100, 12), torch.float32),    # 8 D-ranks, a DSMEM combine a row
    ((10, 300, 40), torch.bfloat16),   # 2 D-ranks x 4 row-ranks, R = 2
    ((300, 5, 9), torch.float32),      # two compaction passes
    ((2, 300, 64), torch.float32),     # 2 D-ranks x 2 row-ranks, R = 2
])
@pytest.mark.parametrize("masked", [False, True])
def test_general_model_matches_plain(shape, dtype, masked):
    """The kernel's order of sums, emulated, is the plain version's Eq. 2
    to the file's tolerance; NaN in the masked rows is never read."""
    n = shape[0]
    a = _t(_normal(shape, 0), "float32").to(dtype)
    g = _t(_normal(shape, 1, 0.1), "float32").to(dtype)
    mask = _mask_with_holes(n, 4) if masked else None
    if masked:
        a[mask == 0], g[mask == 0] = float("nan"), float("nan")
    scale = 0.5 if masked else 1.0 / (2 * n)
    got = _general_model(a, g, mask, scale, masked)
    want = fisher_ref(a, g, mask)
    assert torch.isfinite(got).all()
    tol = TOL[str(dtype).split(".")[-1]]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GENERAL_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_general_matches_plain(cuda_device, name, dtype, masked):
    """The (N, D, C) kernel at the four named shapes against the plain
    version, NaN in the masked rows; two runs bit-equal; the launch the
    library makes is the model's."""
    shape = GENERAL_SHAPES[name]
    a = _t(_normal(shape, 0), dtype).to(cuda_device)
    g = _t(_normal(shape, 1, 0.1), dtype).to(cuda_device)
    mask = _mask_with_holes(shape[0], 5).to(cuda_device) if masked else None
    if masked:
        a[mask == 0], g[mask == 0] = float("nan"), float("nan")
    n0 = ops.fisher.launches
    got = ops.fisher(a, g, mask=mask)
    again = ops.fisher(a, g, mask=mask)
    assert ops.fisher.launches == n0 + 2
    want = fisher_ref(a, g, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    plan = FK.general_launch_plan(a, g)
    model = FK.general_plan(*shape, a.dtype)
    assert {k: plan[k] for k in FK.GENERAL_PLAN_KEYS} == {
        k: model[k] for k in FK.GENERAL_PLAN_KEYS}
