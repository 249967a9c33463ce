"""The port's MLA layer (``models.layers.mla_apply``) on the CPU against
the JAX package's, on deepseek-smoke's shapes (4 heads, q_lora 32, a
16-wide latent, qk_nope 16 + qk_rope 8 against a value dim of 16), f32,
with the JAX weights bridged across: the cache-free forward with and
without a head delta (and its gradients), and a sequence of cache writes
and reads (a ragged block prefill, a second block past a paused slot, a
single-token decode, an aligned write) on the contiguous latent cache and
on paged latent stores, fp and int8: outputs, lengths and the latent rows
themselves.  Within the port: a decode step masked for a slot writes no
latent row, contiguous or paged, and keeps its length."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.serving import paging as JPG
from repro_torch import bridge, configs
from repro_torch.models import layers as L
from repro_torch.serving import paging as PG

ARCH = "deepseek-v3-671b"
B, MAX_LEN, PAGE = 3, 24, 4
TOL = dict(rtol=1e-5, atol=1e-5)
# (tokens a call, valid lengths a slot or None for all valid)
STEPS = ((5, (5, 3, 0)), (5, (4, 0, 5)), (1, None), (1, None))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    jp = jax.tree_util.tree_map(np.asarray,
                                JL.mla_init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
          for n, _ in STEPS]
    return jcfg, cfg, jp, bridge.tree_from_numpy(jp, device="cpu"), xs


def t(a):
    return torch.from_numpy(np.array(a))


def test_cache_free_forward_matches_reference(layer):
    """Per-head K/V from the latent (query/key dim 24, value dim 16)
    through the causal plain attention; with a delta on heads 1 and 3
    (``w_uq`` columns of 24, ``wo`` rows of 16) and its gradients."""
    jcfg, cfg, jp, tp, xs = layer
    x = np.concatenate(xs[:2], axis=1)
    pos = np.broadcast_to(np.arange(x.shape[1]), x.shape[:2])
    want, _ = JL.mla_apply(jp, jnp.asarray(x), jcfg, positions=pos)
    got, cache = L.mla_apply(tp, t(x), cfg, positions=t(pos))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    rng = np.random.default_rng(5)
    idx = np.array([1, 3])
    delta = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in JL.mla_delta_init(jcfg, 2).items()}
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(d):
        y, _ = JL.mla_apply(jp, jnp.asarray(x), jcfg, positions=pos,
                            delta=d, head_idx=idx)
        return jnp.sum(y * w), y

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, delta))
    d_t = {k: t(v).requires_grad_() for k, v in delta.items()}
    y, _ = L.mla_apply(tp, t(x), cfg, positions=t(pos), delta=d_t,
                       head_idx=t(idx))
    torch.sum(y * t(w)).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    for k in delta:
        np.testing.assert_allclose(d_t[k].grad.numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-4, atol=1e-5)


def _jax_caches(jcfg, paging):
    lens = jnp.zeros((B,), jnp.int32)
    if paging is None:
        return {"ckv": jnp.zeros((B, MAX_LEN, jcfg.kv_lora_rank)),
                "krope": jnp.zeros((B, MAX_LEN, jcfg.qk_rope_dim)),
                "len": lens}
    spec = JPG.PagingSpec.build(MAX_LEN, page_size=PAGE, slots=B,
                                int8=paging == "int8")
    # slot b owns pages b, b + B, b + 2B, ... (interleaved, not in order)
    table = (np.arange(spec.max_pages)[None, :] * B
             + np.arange(B)[:, None]).astype(np.int32)
    return {"ckv": JPG.store_init(spec, (jcfg.kv_lora_rank,), jnp.float32),
            "krope": JPG.store_init(spec, (jcfg.qk_rope_dim,), jnp.float32),
            "page_table": jnp.asarray(table), "len": lens}


def _port_caches(jcache):
    out = {"len": t(np.asarray(jcache["len"]))}
    for key in ("ckv", "krope"):
        if isinstance(jcache[key], dict):
            out[key] = bridge.page_store_from_numpy(
                jax.tree_util.tree_map(np.asarray, jcache[key]),
                device="cpu")
        else:
            out[key] = t(np.array(jcache[key]))
    if "page_table" in jcache:
        out["page_table"] = t(np.asarray(jcache["page_table"]))
    return out


def _rows(cache, key):
    """A cache's latent rows as the logical (B, cap, feat) view."""
    if isinstance(cache[key], dict):
        if isinstance(cache[key]["pages"], torch.Tensor):
            spec = PG.spec_from(cache)
            return PG.read_rows(cache[key], cache["page_table"], spec,
                                torch.float32).numpy()
        spec = JPG.spec_from(cache)
        return np.asarray(JPG.read_rows(cache[key], cache["page_table"],
                                        spec, jnp.float32))
    return np.asarray(cache[key])


@pytest.mark.parametrize("paging", [None, "fp", "int8"])
def test_cached_paths_match_reference(layer, paging):
    """A ragged block, a second block (slot 1 paused), two single-token
    decodes: outputs at the valid positions, lengths and latent rows
    (int8 pages hold the same codes and scales), then an aligned write on
    the contiguous cache."""
    jcfg, cfg, jp, tp, xs = layer
    jc = _jax_caches(jcfg, paging)
    tc = _port_caches(jc)
    lens = np.zeros(B, np.int64)
    for x, (n, valid_lens) in zip(xs, STEPS):
        pos = lens[:, None] + np.arange(n)[None, :]
        valid = (None if valid_lens is None else
                 np.arange(n)[None, :] < np.array(valid_lens)[:, None])
        want, jc = JL.mla_apply(jp, jnp.asarray(x), jcfg, positions=pos,
                                cache=jc, valid=valid)
        got, tc = L.mla_apply(tp, t(x), cfg, positions=t(pos), cache=tc,
                              valid=None if valid is None else t(valid))
        ok = (np.ones((B, n), bool) if valid is None else valid)
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok],
                                   **TOL)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
        lens = np.asarray(jc["len"]).astype(np.int64)
        for key in ("ckv", "krope"):
            lim = lens.max()
            np.testing.assert_allclose(_rows(tc, key)[:, :lim],
                                       _rows(jc, key)[:, :lim], **TOL)
    if paging is None:  # batch-aligned write at lens[0] for every slot
        x = xs[0]
        pos = np.broadcast_to(lens[0] + np.arange(5), (B, 5))
        want, jc = JL.mla_apply(jp, jnp.asarray(x), jcfg, positions=pos,
                                cache=dict(jc, len=jnp.full(
                                    (B,), lens[0], jnp.int32)))
        got, tc = L.mla_apply(tp, t(x), cfg, positions=t(pos.copy()),
                              cache=dict(tc, len=torch.full(
                                  (B,), int(lens[0]), dtype=torch.int32)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tc["ckv"].numpy(),
                                   np.asarray(jc["ckv"]), **TOL)


@pytest.mark.parametrize("paging", [None, "fp", "int8"])
def test_masked_decode_writes_no_latent_row(layer, paging):
    """``step_valid`` masks slot 1 of a decode step: its latent rows and
    length keep every byte, and the other slots' outputs equal the
    unmasked call's."""
    jcfg, cfg, _, tp, xs = layer
    jc = _jax_caches(jcfg, paging)
    tc = _port_caches(jc)
    x0 = t(xs[0])
    pos0 = torch.arange(5)[None].expand(B, 5)
    L.mla_apply(tp, x0, cfg, positions=pos0, cache=tc,
                valid=torch.ones((B, 5), dtype=torch.bool))
    tc["len"] = torch.full((B,), 5, dtype=torch.int32)
    # a copy (page stores through the bridge, which keeps the spare row
    # behind each arena that dropped writes go to)
    snap = {k: (v.clone() if isinstance(v, torch.Tensor)
                else bridge.page_store_from_numpy(
                    {n: a.numpy() for n, a in v.items()}, device="cpu"))
            for k, v in tc.items()}
    x1, pos1 = t(xs[2]), torch.full((B, 1), 5)
    mask = torch.tensor([True, False, True])
    masked, after = L.mla_apply(tp, x1, cfg, positions=pos1, cache=tc,
                                step_valid=mask)
    for key in ("ckv", "krope"):
        np.testing.assert_array_equal(_rows(after, key)[1],
                                      _rows(snap, key)[1])
        assert not np.array_equal(_rows(after, key)[0], _rows(snap, key)[0])
    assert after["len"].tolist() == [6, 5, 6]
    full, _ = L.mla_apply(tp, x1, cfg, positions=pos1, cache=snap)
    assert torch.equal(masked[0], full[0]) and torch.equal(masked[2], full[2])
