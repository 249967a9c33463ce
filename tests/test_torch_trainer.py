"""The port's fault-tolerant ``Trainer`` on the CPU: an injected failure
and a restart reach the uninterrupted run's state bit for bit (on the card
too, in the ``cuda`` case); a checkpoint the JAX package's ``Trainer``
wrote at step 4 resumes in the port and reaches the JAX run's losses at
steps 5-12; the non-finite skip, ``max_skips`` and the straggler count
behave as the JAX ``Trainer``'s on the same step function and clock.

JAX is imported inside the reference fixtures only, so that the card's
machine (no JAX) runs the ``cuda`` case."""
import shutil
import time

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenLoader
from repro_torch.launch.train import full_training, train_optimizer
from repro_torch.models import transformer as T
from repro_torch.models.api import ArchConfig
from repro_torch.runtime import (
    SimulatedFailure, Trainer, TrainerConfig, failure_at,
)
from repro_torch.utils import tree_leaves

# the reference test's model (tests/test_system.py)
CFG = dict(name="t", family="dense", n_layers=2, d_model=32, vocab=64,
           n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, dtype="float32")
STEPS, CKPT_EVERY, LR = 12, 4, 1e-3
LOADER = dict(global_batch=4, seq=16, seed=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: several CPU threads per op only contend under the
    parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(params, cfg, device, ckpt_dir, hook=None):
    """The training launcher's full-train pieces under ``Trainer``."""
    step_fn, init = full_training(cfg, params, train_optimizer(LR, STEPS),
                                  device)
    tc = TrainerConfig(total_steps=STEPS, ckpt_every=CKPT_EVERY,
                       ckpt_dir=ckpt_dir, log_every=1000)
    tr = Trainer(tc, step_fn, TokenLoader(CFG["vocab"], **LOADER),
                 failure_hook=hook, log_fn=lambda s: None)
    return tr.run(init), tr


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_failure_and_restart_equal_uninterrupted_run(tmp_path, device):
    """The twin of ``test_system.py::test_trainer_failure_recovery``:
    params and Adam state bit for bit."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    dev = torch.device(device)
    cfg = ArchConfig(**CFG).validate()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    d1 = str(tmp_path / "a")
    with pytest.raises(SimulatedFailure):
        _run(params, cfg, dev, d1, hook=failure_at(9))
    assert CheckpointManager(d1).all_steps() == [4, 8]
    st, tr = _run(params, cfg, dev, d1)  # restart: resumes from step 8
    assert len(tr.losses) == STEPS - 8
    ref, tr_ref = _run(params, cfg, dev, str(tmp_path / "b"))
    assert st.step == ref.step == STEPS
    assert tr.losses == tr_ref.losses[8:]
    for a, b in zip(tree_leaves(st.train_state),
                    tree_leaves(ref.train_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's ``Trainer`` over the same model, loader, optimiser
    and schedule: its losses and its checkpoint directory."""
    import jax
    import jax.numpy as jnp

    from repro.core.baselines import make_full_train_step
    from repro.data import TokenLoader as JTokenLoader
    from repro.models import transformer as JT
    from repro.models.api import ArchConfig as JArchConfig
    from repro.optim import adam, warmup_cosine
    from repro.runtime import Trainer as JTrainer
    from repro.runtime import TrainerConfig as JTrainerConfig

    cfg = JArchConfig(**CFG).validate()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, params)  # the step donates
    opt = adam(warmup_cosine(LR, STEPS, warmup_steps=max(1, STEPS // 20)))
    step = make_full_train_step(lambda p, b: JT.lm_loss(cfg, p, b), opt)

    def step_fn(ts, batch):
        p, ost = ts
        p, ost, loss = step(p, ost,
                            {k: jnp.asarray(v) for k, v in batch.items()})
        return (p, ost), loss

    d = str(tmp_path_factory.mktemp("jax_trainer"))
    tc = JTrainerConfig(total_steps=STEPS, ckpt_every=CKPT_EVERY,
                        ckpt_dir=d, log_every=1000)
    tr = JTrainer(tc, step_fn, JTokenLoader(CFG["vocab"], **LOADER),
                  log_fn=lambda s: None)
    tr.run((params, opt.init(params)))
    return host, tr.losses, d


def test_resumes_a_jax_checkpoint(jax_run, tmp_path):
    """The JAX ``Trainer``'s step-4 checkpoint (params, Adam state, the
    loader's cursor) resumes in the port's ``Trainer``, which reaches the
    JAX run's losses at steps 5-12."""
    jparams, jlosses, jdir = jax_run
    d = tmp_path / "resume"
    d.mkdir()
    shutil.copytree(f"{jdir}/step_4", d / "step_4")
    cfg = ArchConfig(**CFG).validate()
    like = bridge.params_from_numpy(cfg, jparams, device="cpu")
    logs = []
    step_fn, init = full_training(cfg, like, train_optimizer(LR, STEPS),
                                  torch.device("cpu"))
    tc = TrainerConfig(total_steps=STEPS, ckpt_every=CKPT_EVERY,
                       ckpt_dir=str(d), log_every=1000)
    tr = Trainer(tc, step_fn, TokenLoader(CFG["vocab"], **LOADER),
                 log_fn=logs.append)
    st = tr.run(init)
    assert logs == ["[trainer] restored step 4"]
    assert st.step == STEPS and len(tr.losses) == STEPS - 4
    np.testing.assert_allclose(tr.losses, jlosses[4:], rtol=1e-5)
    # and the JAX run's step-4 state is what the port restored
    restored, extra = CheckpointManager(jdir).restore(4, init)
    assert extra["loader"] == {"step": 4, "seed": LOADER["seed"]}
    assert int(restored[1]["step"]) == 4


class _Counter:
    """A step function over a one-leaf state that adds 1 a step and
    reports the given losses in turn, advancing a fake clock by the given
    step times."""

    def __init__(self, losses, times=None, clock=None):
        self.losses, self.times, self.clock = list(losses), times, clock
        self.i = 0

    def __call__(self, ts, batch):
        loss = self.losses[self.i]
        if self.times is not None:
            self.clock["now"] += self.times[self.i]
        self.i += 1
        return {"w": ts["w"] + 1}, loss


def _trainers():
    """(package, Trainer, TrainerConfig, a zero state) for both."""
    from repro.runtime import Trainer as JTrainer
    from repro.runtime import TrainerConfig as JTrainerConfig

    return (("port", Trainer, TrainerConfig,
             {"w": torch.zeros(2, dtype=torch.float32)}),
            ("jax", JTrainer, JTrainerConfig,
             {"w": np.zeros(2, np.float32)}))


@pytest.mark.parametrize("max_skips,raises", [(10, False), (1, True)])
def test_non_finite_steps_are_skipped_as_in_jax(tmp_path, monkeypatch,
                                                max_skips, raises):
    """A non-finite loss keeps the previous state and counts a skip; more
    than ``max_skips`` abort.  Both packages' Trainers, one step function,
    on one fake clock at equal step times, so that neither logs a
    straggler step that the other does not."""
    losses = [1.0, float("nan"), 2.0, float("inf"), 3.0, 4.0]
    clock = {"now": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["now"])
    seen = {}
    for name, trainer, config, zero in _trainers():
        logs = []
        tc = config(total_steps=len(losses), ckpt_every=100,
                    ckpt_dir=str(tmp_path / name), max_skips=max_skips,
                    log_every=2)
        tr = trainer(tc, _Counter(losses, [1.0] * len(losses), clock),
                     TokenLoader(64, 2, 4), log_fn=logs.append)
        if raises:
            with pytest.raises(RuntimeError, match="too many non-finite"):
                tr.run(zero)
            seen[name] = (logs,)
            continue
        st = tr.run(zero)
        assert st.skipped == 2 and st.step == len(losses)
        assert tr.losses == [1.0, 2.0, 3.0, 4.0]
        np.testing.assert_array_equal(np.asarray(st.train_state["w"]),
                                      [4.0, 4.0])
        seen[name] = ([s.split(" (")[0] for s in logs],)
    assert seen["port"] == seen["jax"]
    if not raises:
        _, tree, extra = CheckpointManager(
            str(tmp_path / "port")).restore_latest(
                {"w": torch.zeros(2, dtype=torch.float32)})
        assert extra["skipped"] == 2 and float(tree["w"][0]) == 4.0


def test_straggler_events_counted_as_in_jax(tmp_path, monkeypatch):
    """A step slower than 3x the EWMA of step times is a straggler event,
    carried in the checkpoint; both packages' Trainers on one fake clock."""
    times = [1.0, 1.0, 1.0, 5.0, 1.0, 10.0, 1.0]
    clock = {"now": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["now"])
    seen = {}
    for name, trainer, config, zero in _trainers():
        logs = []
        tc = config(total_steps=len(times), ckpt_every=100,
                    ckpt_dir=str(tmp_path / name), log_every=100)
        tr = trainer(tc, _Counter([0.5] * len(times), times, clock),
                     TokenLoader(64, 2, 4), log_fn=logs.append)
        st = tr.run(zero)
        seen[name] = (st.straggler_events, logs)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 2
    assert seen["port"][1][0].startswith("[trainer] straggler step 3: "
                                         "5.000s vs ewma 1.000s")
    _, _, extra = CheckpointManager(str(tmp_path / "port")).restore_latest(
        {"w": torch.zeros(2, dtype=torch.float32)})
    assert extra["straggler_events"] == 2
