"""The port's dense transformer against the JAX package's, on the dense
smoke configs in float32 with the JAX weights bridged across as numpy
arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge, configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine
from repro_torch.utils import tree_map

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(
        configs.get_reduced("qwen2-1.5b"),
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_configs_are_the_reference_configs():
    for arch in jconfigs.lm_arch_ids():
        for get in ("get_config", "get_reduced"):
            want = getattr(jconfigs, get)(arch)
            got = getattr(configs, get)(arch)
            assert vars(got) == vars(want), (arch, get)


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    _close(L.rms_norm(_t(x), _t(w)), JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    cos, sin = L.rope_tables(_t(pos), 16, 10_000.0)
    jcos, jsin = JL.rope_tables(jnp.asarray(pos), 16, 10_000.0)
    _close(cos, jcos)
    _close(sin, jsin)
    _close(L.apply_rope(_t(x), cos, sin),
           JL.apply_rope(jnp.asarray(x), jcos, jsin))


def test_mlp_apply(model):
    cfg, jp, tp = model
    x = np.random.default_rng(1).standard_normal((2, 3, cfg.d_model))
    x = x.astype(np.float32)
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["stacks"]["g0"]["mlp"])
    tm = tree_map(lambda a: a[0], tp["stacks"]["g0"]["mlp"])
    _close(L.mlp_apply(tm, _t(x), cfg.act),
           JL.mlp_apply(jm, jnp.asarray(x), cfg.act))


def _cache(rng, cfg, b, s_max, lens):
    shape = (b, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32),
            "len": np.asarray(lens, np.int32)}


@pytest.mark.parametrize("mode", ["decode", "block", "aligned"])
def test_attention_apply_with_cache(model, mode):
    """Decode (one token per slot at its own length), block prefill
    (ragged valid prefixes, one paused slot) and a batch-aligned
    multi-token write against the JAX layer: the output rows that are
    valid, and the whole cache after the writes."""
    cfg, jp, tp = model
    rng = np.random.default_rng(2)
    b, s_max = 3, 32
    lens = np.asarray([6, 6, 6] if mode == "aligned" else [0, 4, 10],
                      np.int32)
    s = {"decode": 1, "block": 8, "aligned": 3}[mode]
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    positions = lens[:, None] + np.arange(s)[None, :]
    valid = None
    if mode == "block":
        valid = np.arange(s)[None, :] < np.asarray([8, 5, 0])[:, None]
    cache = _cache(rng, cfg, b, s_max, lens)
    ja = jax.tree_util.tree_map(lambda a: a[0], jp["stacks"]["g0"]["attn"])
    ta = tree_map(lambda a: a[0], tp["stacks"]["g0"]["attn"])
    jy, jc = JL.attention_apply(
        ja, jnp.asarray(x), cfg, positions=jnp.asarray(positions),
        cache=jax.tree_util.tree_map(jnp.asarray, cache),
        valid=None if valid is None else jnp.asarray(valid))
    ty, tc = L.attention_apply(
        ta, _t(x), cfg, positions=_t(positions),
        cache=tree_map(_t, cache), valid=None if valid is None else _t(valid))
    rows = np.ones((b, s), bool) if valid is None else valid
    _close(ty[torch.from_numpy(rows)], np.asarray(jy)[rows])
    for name in ("k", "v", "len"):
        _close(tc[name], jc[name])


def _blocks():
    """Two block-prefill calls (ragged; slot 2 pauses in the second) and a
    decode step, as a serving engine would issue them."""
    rng = np.random.default_rng(3)
    return [
        ("block", rng.integers(0, 256, (3, 8)), np.asarray([0, 0, 0]),
         np.arange(8)[None, :] < np.asarray([8, 5, 3])[:, None]),
        ("block", rng.integers(0, 256, (3, 8)), np.asarray([8, 5, 3]),
         np.arange(8)[None, :] < np.asarray([4, 8, 0])[:, None]),
        ("decode", rng.integers(0, 256, (3, 1)), np.asarray([12, 13, 3]),
         None),
    ]


def _bridged(arch):
    cfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = JT.init_params(cfg, jax.random.PRNGKey(1))
    tp = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


# every dense config: SwiGLU + rmsnorm + QKV bias (qwen2), GeGLU (gemma),
# layernorm + untied unembedding (stablelm), GELU + layernorm (starcoder2)
DENSE = ["qwen2-1.5b", "gemma-2b", "stablelm-12b", "starcoder2-3b"]


@pytest.mark.parametrize("arch", DENSE)
def test_forward_hidden_without_cache(arch):
    cfg, tcfg, jp, tp = _bridged(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 7))
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    jh, _, _ = JT.forward_hidden(
        cfg, jp, JT.embed_tokens(cfg, jp, jnp.asarray(toks)), jnp.asarray(pos))
    th, _ = T.forward_hidden(
        tcfg, tp, T.embed_tokens(tcfg, tp, _t(toks)), _t(pos))
    _close(th, jh)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_block_and_decode_step(arch):
    cfg, tcfg, jp, tp = _bridged(arch)
    jc = JT.init_caches(cfg, 3, 32)
    tc = T.init_caches(tcfg, 3, 32, device="cpu")
    for kind, toks, pos, valid in _blocks():
        toks = (toks % cfg.vocab).astype(np.int32)
        pos = pos.astype(np.int32)
        if kind == "block":
            jl, jc = JT.prefill_block(cfg, jp, jnp.asarray(toks), jc,
                                      jnp.asarray(pos), jnp.asarray(valid))
            tl, tc = T.prefill_block(tcfg, tp, _t(toks).long(), tc, _t(pos),
                                     _t(valid))
            rows = valid
        else:
            jl, jc = JT.decode_step(cfg, jp, jnp.asarray(toks), jc,
                                    jnp.asarray(pos))
            tl, tc = T.decode_step(tcfg, tp, _t(toks).long(), tc, _t(pos))
            rows = np.ones(toks.shape, bool)
        _close(tl[torch.from_numpy(rows)], np.asarray(jl)[rows])
        jleaves = jax.tree_util.tree_leaves_with_path(jc)
        tflat = {"g0/attn/" + n: t for n, t in tc["g0"]["attn"].items()}
        assert len(jleaves) == len(tflat)
        for path, leaf in jleaves:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            _close(tflat[key], leaf)


def test_reset_slot_state_zeros_only_masked_lengths():
    cfg = configs.get_reduced("qwen2-1.5b")
    c = T.init_caches(cfg, 3, 16, device="cpu")
    c["g0"]["attn"]["len"] += 5
    T.reset_slot_state(c, torch.tensor([True, False, True]))
    assert c["g0"]["attn"]["len"].tolist() == [[0, 5, 0]] * cfg.n_layers


def test_default_device_raises_without_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg, jp, tp = model
    tcfg = configs.get_reduced("qwen2-1.5b")
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    for call in (lambda: T.init_caches(tcfg, 2, 16),
                 lambda: T.init_params(tcfg, torch.Generator()),
                 lambda: bridge.params_from_numpy(tcfg, np_tree),
                 lambda: ServeEngine(tcfg, tp)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-1.2b",
                                  "whisper-base", "deepseek-v3-671b"])
def test_families_of_later_slices_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_caches(configs.get_reduced(arch), 2, 16, device="cpu")


def test_init_params_layout_matches_reference(model):
    """Same tree, shapes and dtypes as the JAX init (the numbers differ:
    torch's generator, not jax.random)."""
    cfg, jp, _ = model
    tp = T.init_params(configs.get_reduced("qwen2-1.5b"),
                       torch.Generator().manual_seed(0), device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jl:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
