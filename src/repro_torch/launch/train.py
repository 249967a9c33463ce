"""Training launcher: the port of ``repro.launch.train``.

Runs TinyTrain sparse fine-tuning (or FullTrain) of a registered LM arch
on the synthetic token pipeline, with fault-tolerant checkpointing
(``runtime.Trainer``; checkpoints in the JAX package's format, so either
package resumes the other's).  ``--mode tinytrain`` probes one batch,
selects a policy under the device profile (``plan_sparse_update``) and
trains the deltas (``make_sparse_train_step``); ``--mode full`` trains
every parameter (``make_full_train_step``); both under Adam with a linear
warmup and cosine decay.  ``examples/distributed_finetune.py``'s twin:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --preset smoke --steps 60 --batch 8 --seq 128 --mode tinytrain \
        --mem-budget-mb 8 --compute-frac 0.5 --ckpt-dir CKPT

At ``--preset full`` that 8 MB envelope selects no unit of qwen2-1.5b;
``--mem-budget-mb 2000 --compute-frac 0.8`` trains one.  A rerun with the same ``--ckpt-dir`` resumes from the latest checkpoint
(and runs no step when it already covers ``--steps``).

Runs on the card unless ``--device cpu``.  Weights are random, from a
``torch.Generator`` seeded with ``--seed``.  (In ``repro.launch.train``
``--device`` names the device profile; here it is the torch device, and
``--profile`` names the profile, as in ``repro_torch.launch.serve``.)
``--production-mesh`` lays the pod's (16, 16) ("data", "model") mesh over
that device and prints it, as the JAX launcher prints ``dict(mesh.shape)``;
the mesh is only printed, and training proceeds as on the debug mesh.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import api, configs
from ..core.baselines import make_full_train_step
from ..core.sparse import make_sparse_train_step
from ..data import TokenLoader
from ..models import transformer as T
from ..optim import Optimizer, adam, warmup_cosine
from ..runtime import Trainer, TrainerConfig
from ..utils import resolve_device, tree_leaves
from .mesh import make_debug_mesh, make_production_mesh


# kept for older callers; the canonical resolver lives in repro_torch.configs
preset_config = configs.preset_config


def on_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_optimizer(lr: float, steps: int) -> Optimizer:
    """Adam under a linear warmup over a twentieth of the steps (at least
    one) and a cosine decay to 0 at ``steps``."""
    return adam(warmup_cosine(lr, steps, warmup_steps=max(1, steps // 20)))


def sparse_training(bb, params: Any, loader: TokenLoader, profile,
                    opt: Optimizer, device: torch.device, n_samples: int):
    """TinyTrain Algorithm 1 on a token stream: probe the loader's next
    batch, select a policy, then sparse steps.  Returns (step_fn,
    init_state (deltas, opt_state), policy, fisher_seconds)."""
    probe = on_device(loader.next(), device)
    policy, fisher_dt = api.plan_sparse_update(bb, params, probe, profile,
                                               n_samples=n_samples)
    deltas = bb.init_deltas(policy, device)
    step = make_sparse_train_step(bb.loss, policy, opt, donate=False)

    def step_fn(ts, batch):
        d, ost = ts
        d, ost, loss = step(params, d, ost, on_device(batch, device))
        return (d, ost), loss

    return step_fn, (deltas, opt.init(deltas)), policy, fisher_dt


def full_training(cfg, params: Any, opt: Optimizer, device: torch.device):
    """FullTrain: every parameter differentiated.  Returns (step_fn,
    init_state (params, opt_state))."""
    step = make_full_train_step(lambda p, b: T.lm_loss(cfg, p, b), opt)

    def step_fn(ts, batch):
        p, ost = ts
        p, ost, loss = step(p, ost, on_device(batch, device))
        return (p, ost), loss

    return step_fn, (params, opt.init(params))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", default="tinytrain",
                    choices=["tinytrain", "full"])
    ap.add_argument("--profile", default=None,
                    help="device profile preset "
                         f"({', '.join(sorted(api.PROFILES))})")
    ap.add_argument("--mem-budget-mb", type=float, default=64.0)
    ap.add_argument("--compute-frac", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights' generator")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.preset_config(args.arch, args.preset)
    if args.production_mesh:
        # the pod layout's 256 positions over the chosen device; the step
        # runs on that device as on the debug mesh
        mesh = make_production_mesh(devices=[device])
    elif device.type == "cuda":
        mesh = make_debug_mesh(torch.cuda.device_count())
    else:
        mesh = make_debug_mesh(1, devices=[device])
    print(f"[train] arch={cfg.name} mode={args.mode} mesh={mesh.shape}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] params: {n_params/1e6:.1f}M")

    loader = TokenLoader(cfg.vocab, global_batch=args.batch, seq=args.seq,
                         seed=0)
    opt = train_optimizer(args.lr, args.steps)
    bb = api.backbone(args.arch, preset=args.preset,
                      batch_size=args.batch, seq=args.seq)

    if args.profile:
        if args.mem_budget_mb != 64.0 or args.compute_frac != 0.5:
            print("[train] WARNING: --profile overrides "
                  "--mem-budget-mb/--compute-frac")
        profile = api.device_profile(args.profile)
    else:
        profile = api.DeviceProfile(name="cli",
                                    mem_kb=args.mem_budget_mb * 1e3,
                                    compute_frac=args.compute_frac)

    if args.mode == "full":
        step_fn, init_state = full_training(cfg, params, opt, device)
    else:
        t0 = time.perf_counter()
        step_fn, init_state, policy, fisher_dt = sparse_training(
            bb, params, loader, profile, opt, device, n_samples=args.batch)
        print(f"[train] profile={profile.name} fisher {fisher_dt:.1f}s "
              f"(total selection {time.perf_counter()-t0:.1f}s)")
        print(f"[train] policy: {policy.describe()}")

    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir)
    trainer = Trainer(tc, step_fn, loader)
    t0 = time.perf_counter()
    state = trainer.run(init_state)
    dt = time.perf_counter() - t0
    # a resumed run whose checkpoint already covers --steps executes zero
    # new steps and records no losses
    final = (f"final loss {trainer.losses[-1]:.4f}" if trainer.losses
             else "no new steps (checkpoint already at --steps)")
    print(f"[train] done: {state.step} steps in {dt:.1f}s "
          f"({dt/max(state.step,1)*1e3:.0f} ms/step), {final}")


if __name__ == "__main__":
    main()
