"""The port's ``ShardingRules`` against the JAX package's, on mesh-shaped
fakes (no devices): the six cases of ``tests/test_dist.py``'s
``TestShardingRules``, then, for every LM architecture at its published
config, the spec of every leaf of the params (``jax.eval_shape`` of the JAX
init against the port's shape-only init on the meta device), the dry-run
policy's deltas, its Adam state, every shape cell's batch and the decode
cells' caches, on the 16 x 16 and 2 x 16 x 16 production meshes, with and
without sequence parallelism.

The JAX rules lower each spec to a ``NamedSharding`` of a real mesh; here
their ``_named`` hands the spec back instead, so both packages' trees of
specs are compared leaf by leaf under the same key paths."""
import os

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.core.backbones import lm_backbone as jlm_backbone
from repro.dist.sharding import ShardingRules as JRules
from repro.models import transformer as JT
from repro.models.api import SHAPES_BY_NAME as JSHAPES
from repro_torch import configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.dist import ShardingRules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.api import SHAPES, SHAPES_BY_NAME
from repro_torch.utils import named_tree_map


class FakeMesh:
    def __init__(self, multi_pod: bool = False, tp: int = 16):
        self.axis_names = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names,
                              (2, 16, tp) if multi_pod else (16, tp)))


def rules(arch, tp=16, **kw):
    return ShardingRules(configs.get_config(arch), FakeMesh(tp=tp), **kw)


@pytest.fixture(scope="module")
def jdry():
    """The JAX dry run's module, imported without keeping its process-wide
    ``XLA_FLAGS`` (it asks for 512 host devices, which every later JAX
    start in this worker and its subprocesses would get)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    assert os.environ.get("XLA_FLAGS") == saved
    return jd


# -- tests/test_dist.py's TestShardingRules, on the port -------------------


class TestShardingRules:
    def test_gemma_heads_replicated_ffn_sharded(self):
        r = rules("gemma-2b")
        assert not r.shard_q_heads  # 8 heads on 16-way TP
        assert r.shard_ffn
        spec = r.param_spec("stacks/g0/attn/wq", (18, 2048, 2048))
        assert all(s is None for s in spec)
        spec = r.param_spec("stacks/g0/mlp/w_gate", (18, 2048, 16384))
        assert spec[-1] == "model"

    def test_deepseek_full_ep(self):
        r = rules("deepseek-v3-671b")
        assert r.shard_experts_full
        spec = r.param_spec("stacks/g1/moe/w_gate", (58, 256, 7168, 2048))
        assert spec[1] == ("model", "data")

    def test_mixtral_expert_tp(self):
        r = rules("mixtral-8x7b")
        assert not r.shard_experts  # 8 experts on 16-way
        assert r.shard_expert_ffn
        spec = r.param_spec("stacks/g0/moe/w_down", (32, 8, 14336, 4096))
        assert spec[2] == "model"

    def test_vocab_guard(self):
        r = rules("whisper-base")
        assert not r.shard_vocab  # 51865 % 16 != 0
        spec = r.param_spec("embed", (51865, 512))
        assert all(s is None for s in spec)

    def test_ssm_head_sharding(self):
        r = rules("mamba2-1.3b")
        assert r.shard_ssm  # 64 SSD heads / 16
        spec = r.param_spec("stacks/g0/ssm/w_x", (48, 2048, 4096))
        assert spec[-1] == "model"

    def test_seq_parallel_replicates_block_weights(self):
        r = rules("gemma-2b", seq_parallel=True)
        spec = r.param_spec("stacks/g0/mlp/w_gate", (18, 2048, 16384))
        assert all(s is None for s in spec)
        assert r.batch_spec()["tokens"][1] == "model"


def test_shard_shape_divides_each_dimension_by_its_axes():
    r = rules("deepseek-v3-671b")
    assert r.shard_shape((None, ("model", "data"), None, None),
                         (58, 256, 7168, 2048)) == (58, 1, 7168, 2048)
    assert r.shard_shape(("model", None), (151936, 1536)) == (9496, 1536)
    assert r.shard_shape((), ()) == ()
    with pytest.raises(ValueError, match="does not split"):
        r.shard_shape(("model",), (51865,))


def test_the_production_mesh_drives_the_rules():
    mesh = make_production_mesh(multi_pod=True, devices=["meta"])
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and set(mesh.devices) == {torch.device("meta")}
    r = ShardingRules(configs.get_config("deepseek-v3-671b"), mesh)
    assert r.dp == ("pod", "data") and r.dp_size == 32 and r.tp == 16
    # 256 experts do not cover 16 x 32 positions: EP over 'model' only
    assert not r.shard_experts_full and r.shard_experts
    assert r.param_spec("stacks/g1/moe/w_up",
                        (58, 256, 7168, 2048))[1] == "model"


# -- every leaf of every architecture, against the JAX rules ---------------


class _Spec:
    """A spec wrapped so that JAX's tree utilities keep it one leaf."""

    def __init__(self, spec):
        self.spec = tuple(spec)


def jax_specs(method, *args, **kw):
    """{key path: spec} of a JAX tree method with ``_named`` returning the
    spec itself."""
    out = method(*args, **kw)
    flat, _ = jax.tree_util.tree_flatten_with_path(out)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf.spec for path, leaf in flat}


def port_specs(tree, specs):
    out = {}
    named_tree_map(lambda name, _, s: out.__setitem__(name, tuple(s)),
                   tree, specs)
    return out


_TREES = {}


def trees(arch, jd):
    """Both packages' shape trees of one architecture at its published
    config, built once a module: params, the dry-run policy's deltas and
    Adam state, every shape's batch, the decode shapes' caches."""
    if arch in _TREES:
        return _TREES[arch]
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    jpol = jd.dryrun_policy(jcfg)
    jbb = jlm_backbone(jcfg, tokens_per_batch=1, batch_size=1)
    jd_ = jax.eval_shape(lambda: jbb.init_deltas(jpol))
    _, jopt = jd.build_train_step(jcfg, jpol)
    jo = jax.eval_shape(jopt.init, jd_)
    p = T.init_params(cfg, None, device="meta")
    pol = dryrun.dryrun_policy(cfg)
    d = lm_backbone(cfg, tokens_per_batch=1, batch_size=1).init_deltas(
        pol, "meta")
    o = dryrun.build_train_step(cfg, pol)[1].init(d)
    batches = {s.name: (jd.input_specs(jcfg, JSHAPES[s.name]),
                        dryrun.input_specs(cfg, s)) for s in SHAPES}
    caches = {s.name: (jd.cache_specs(jcfg, JSHAPES[s.name]),
                       dryrun.cache_specs(cfg, s))
              for s in SHAPES if s.kind == "decode"}
    _TREES[arch] = ((jcfg, jp, jd_, jo), (cfg, p, d, o), batches, caches)
    return _TREES[arch]


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", configs.lm_arch_ids())
def test_specs_equal_the_jax_rules_leaf_by_leaf(jdry, arch, multi_pod,
                                                 seq_parallel):
    (jcfg, jp, jd_, jo), (cfg, p, d, o), batches, caches = trees(arch, jdry)
    mesh = FakeMesh(multi_pod)
    jr = JRules(jcfg, mesh, seq_parallel=seq_parallel)
    jr._named = _Spec
    r = ShardingRules(cfg, mesh, seq_parallel=seq_parallel)
    for name, (jt, t, jm, pm) in {
            "params": (jp, p, jr.params, r.params),
            "deltas": (jd_, d, jr.deltas, r.deltas),
            "opt_state": (jo, o, jr.opt_state, r.opt_state)}.items():
        want, got = jax_specs(jm, jt), port_specs(t, pm(t))
        assert got == want, name
        assert len(got) == len(jax.tree_util.tree_leaves(jt)), name
    for shape, (jb, b) in batches.items():
        assert port_specs(b, r.batch(b)) == jax_specs(jr.batch, jb), shape
    for shape, (jc, c) in caches.items():
        batch1 = SHAPES_BY_NAME[shape].global_batch % r.dp_size != 0
        want = jax_specs(jr.caches, jc, seq_sharded=batch1)
        assert port_specs(c, r.caches(c, seq_sharded=batch1)) == want, shape
    assert r.batch_spec() == jr.batch_spec()
    for guard in ("shard_q_heads", "shard_ffn", "shard_vocab", "shard_ssm",
                  "shard_experts", "shard_experts_full",
                  "shard_expert_ffn"):
        assert getattr(r, guard) == getattr(jr, guard), guard


@pytest.mark.parametrize("arch", configs.lm_arch_ids())
def test_the_meta_init_has_the_jax_shapes_and_dtypes(jdry, arch):
    """The port's shape-only trees are ``jax.eval_shape``'s, leaf by leaf:
    the counterpart the dry run and the rules read."""
    (_, jp, jd_, jo), (_, p, d, o), batches, caches = trees(arch, jdry)
    pairs = [(jp, p), (jd_, d), (jo, o)] + list(batches.values()) + list(
        caches.values())
    for jt, t in pairs:
        want = {}
        for path, x in jax.tree_util.tree_flatten_with_path(jt)[0]:
            want["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)] = (tuple(x.shape), str(x.dtype))
        got = {}
        named_tree_map(lambda n, x: got.__setitem__(
            n, (tuple(x.shape), str(x.dtype).replace("torch.", ""))), t)
        assert got == want
        assert all(x.is_meta for x in
                   [v for v in _leaves(t) if isinstance(v, torch.Tensor)])


def _leaves(tree):
    out = []
    named_tree_map(lambda _, x: out.append(x), tree)
    return out
