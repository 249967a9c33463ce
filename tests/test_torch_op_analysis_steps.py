"""The dry run's model steps under the port's op-level cost analyser
against the JAX package's HLO analyser: the prefill, decode and sparse
train steps of ``launch/dryrun.py`` on the smoke config of every family
(B 2, S 64), on the CPU and on the meta device, against ``analyse_hlo`` of
``repro.launch.dryrun``'s steps compiled for one CPU device.  The FLOPs
are equal to rel 1e-6, the MoE decode steps' too: both dry runs count the
capped expert queues of ``decode_step``'s default.  Outside decode, where
a cache is written in place, the bytes the ops write are at least the
floor."""
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.core.backbones import lm_backbone as jlm_backbone
from repro.launch.hlo_analysis import analyse_hlo
from repro.models import transformer as JT
from repro.models.api import ShapeConfig as JShape
from repro_torch import configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import analyse_ops
from repro_torch.models import transformer as T
from repro_torch.models.api import ShapeConfig

B, S = 2, 64
FAMILIES = ("qwen2-1.5b", "mamba2-1.3b", "mixtral-8x7b", "deepseek-v3-671b",
            "zamba2-1.2b", "whisper-base", "paligemma-3b")
# the counts of the smoke steps, as the JAX analyser and the port give them
EXACT = {("qwen2-1.5b", "prefill"): 34_668_544,
         ("mamba2-1.3b", "prefill"): 34_406_400,
         ("mixtral-8x7b", "prefill"): 63_176_704}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdry():
    """The JAX dry run's step builders, imported without keeping its
    process-wide ``XLA_FLAGS``."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    assert os.environ.get("XLA_FLAGS") == saved
    return jd


def hlo(f, *specs):
    return analyse_hlo(jax.jit(f).lower(*specs).compile().as_text())


# -- the dry run's steps, every family's smoke config ------------------------


def jax_step(jd, arch, kind):
    cfg = jconfigs.get_reduced(arch)
    shape = JShape("smoke", S, B, kind)
    params = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
    batch = jd.input_specs(cfg, shape)
    if kind == "train":
        pol = jd.dryrun_policy(cfg)
        bb = jlm_backbone(cfg, tokens_per_batch=1, batch_size=1)
        deltas = jax.eval_shape(lambda: bb.init_deltas(pol))
        step, opt = jd.build_train_step(cfg, pol)
        return hlo(step, params, deltas, jax.eval_shape(opt.init, deltas),
                   batch)
    if kind == "prefill":
        return hlo(jd.build_prefill_step(cfg), params, batch)
    return hlo(jd.build_decode_step(cfg), params, batch,
               jd.cache_specs(cfg, shape),
               jax.ShapeDtypeStruct((B,), jnp.int32))


def port_step(arch, kind, device):
    cfg = configs.get_reduced(arch)
    shape = ShapeConfig("smoke", S, B, kind)
    gen = (None if device == "meta"
           else torch.Generator(device=device).manual_seed(0))
    params = T.init_params(cfg, gen, device=device)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in dryrun.input_specs(cfg, shape).items()}
    if kind == "train":
        pol = dryrun.dryrun_policy(cfg)
        deltas = lm_backbone(cfg, tokens_per_batch=1,
                             batch_size=1).init_deltas(pol, device)
        step, opt = dryrun.build_train_step(cfg, pol)
        return analyse_ops(step, params, deltas, opt.init(deltas), batch)
    if kind == "prefill":
        return analyse_ops(dryrun.build_prefill_step(cfg), params, batch)
    caches = T.init_caches(cfg, B, S, device=device)
    pos = torch.zeros((B,), dtype=torch.int32, device=device)
    return analyse_ops(dryrun.build_decode_step(cfg), params, batch, caches,
                       pos)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_step_flops_equal_the_hlo_analyser(jdry, arch, kind):
    want = jax_step(jdry, arch, kind)["flops"]
    cpu = port_step(arch, kind, "cpu")
    meta = port_step(arch, kind, "meta")
    assert meta["flops"] == cpu["flops"]
    assert cpu["flops"] / want == pytest.approx(1.0, rel=1e-6)
    if (arch, kind) in EXACT:
        assert cpu["flops"] == EXACT[(arch, kind)]
    if kind != "decode":
        # a decode step writes its cache rows in place, which counts no
        # bytes, while the floor reads the whole cache
        assert 0 < cpu["bytes_floor"] <= cpu["bytes"]
    assert meta["bytes_floor"] == cpu["bytes_floor"]
    assert 0 < meta["peak_live_bytes"]
