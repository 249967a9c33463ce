"""Checkpointing: atomic, keep-N, resumable, re-placed on restore: the port
of ``repro.checkpoint.manager``, in the same files.

Layout: ``<dir>/step_<n>/`` holding ``arrays.npz`` (the leaves as
``leaf_{i}``), ``tree.json`` (the structure as JAX prints a ``PyTreeDef``,
the leaf count, dtypes, shapes, time and step) and ``extra.json``
(free-form: data-pipeline cursors, counters).  Writes go to
``.tmp-step_<n>`` and are published with ``os.rename`` (atomic on POSIX),
so a crash mid-save never corrupts the latest checkpoint.  Restores
validate every leaf against ``tree.json`` and the restore target, raising
:class:`CheckpointError` on a truncated or corrupt checkpoint.

The two packages read each other's checkpoints:

- Leaves are numbered in JAX's flattening order, dict keys sorted and
  lists and tuples in order, whatever order a dict was built in.
- numpy has no bfloat16.  A bf16 leaf is written as its raw 2-byte words
  (``|V2`` in the npz), with ``"bfloat16"`` in ``tree.json``, which is
  what ``np.savez`` makes of the JAX package's ``ml_dtypes.bfloat16``
  arrays; such a leaf restores as ``torch.bfloat16`` bit for bit.  (The
  JAX manager refuses its own bf16 checkpoints: its dtype check compares
  the npz's ``|V2`` with the recorded name.)

``restore(..., devices=)`` places each leaf on the given device (a tree of
``torch.device`` of the target's shape, e.g. a mesh's positions): the
counterpart of the JAX manager's ``shardings``, so a checkpoint taken on
one placement restores onto another.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# torch dtypes by the names ``tree.json`` records (numpy's, and JAX's
# "bfloat16")
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_BF16_WORDS = np.dtype("V2")


class CheckpointError(Exception):
    """A checkpoint failed validation on restore: missing/corrupt files,
    arrays that disagree with the saved ``tree.json`` metadata, or a
    structure/dtype/shape mismatch against the restore target."""


def _flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, structure) in JAX's order: dict keys sorted, lists and
    tuples in order, None a node without leaves.  The structure is the
    text of the JAX package's ``str(treedef)`` for the same tree."""
    leaves: List[Any] = []

    def walk(t: Any) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if t is None:
            return "None"
        leaves.append(t)
        return "*"

    structure = walk(tree)
    return leaves, f"PyTreeDef({structure})"


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure (its own dict order) over ``leaves`` given in
    JAX's order."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    return build(like)


def _to_numpy(x: Any) -> np.ndarray:
    """A leaf as the array ``np.savez`` writes; bf16 as its 2-byte words."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16_WORDS)
    return x.numpy()


def _dtype_name(a: np.ndarray) -> str:
    """The name ``tree.json`` records for an array written by
    :func:`_to_numpy`."""
    return "bfloat16" if a.dtype == _BF16_WORDS else str(a.dtype)


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """An array read back from the npz as a CPU tensor (a read-only
    buffer copied once)."""
    if not a.flags.writeable:
        a = a.copy()
    if dtype_name == "bfloat16" and a.dtype == _BF16_WORDS:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        tmp = os.path.join(self.dir, f".tmp-step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves, treedef = _flatten(tree)
        arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {
            "treedef": treedef,
            "n_leaves": len(arrays),
            "dtypes": {k: _dtype_name(v) for k, v in arrays.items()},
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "time": time.time(),
            "step": step,
        }
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra or {}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        step: int,
        like: Any,
        devices: Optional[Any] = None,
    ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like`` (tensors, or meta tensors
        with ``devices`` given), each leaf on its ``like`` leaf's device or
        on ``devices``' (a tree of the same structure): the elastic path.

        Every leaf is validated against the ``tree.json`` metadata written
        at save time (count, dtype, shape) *and* against the restore
        target, so a truncated ``arrays.npz``, a bit-rotted leaf or a
        model-structure drift raises :class:`CheckpointError` instead of
        silently loading garbage into the training state."""
        path = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(path, "tree.json")) as f:
                meta = json.load(f)
            data = np.load(os.path.join(path, "arrays.npz"))
            with open(os.path.join(path, "extra.json")) as f:
                extra = json.load(f)
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            raise CheckpointError(
                f"checkpoint step_{step} is unreadable: {e}") from e
        with data:
            return self._restore_leaves(step, meta, data, like,
                                        devices), extra

    def _restore_leaves(self, step, meta, data, like, devices):
        if meta.get("n_leaves") != len(data.files):
            raise CheckpointError(
                f"step_{step}: arrays.npz holds {len(data.files)} leaves "
                f"but tree.json recorded {meta.get('n_leaves')} — "
                "truncated or mixed-up checkpoint")
        leaves_like, _ = _flatten(like)
        n = len(leaves_like)
        if n != len(data.files):
            raise CheckpointError(
                f"step_{step}: checkpoint has {len(data.files)} leaves, "
                f"restore target has {n} — structure changed since save")
        dev_leaves = (_flatten(devices)[0] if devices is not None
                      else [None] * n)
        out = []
        for i, (ref, dev) in enumerate(zip(leaves_like, dev_leaves)):
            key = f"leaf_{i}"
            try:
                arr = data[key]
            except Exception as e:
                raise CheckpointError(
                    f"step_{step}: leaf {i} missing or undecodable: {e}"
                ) from e
            saved_dtype = meta.get("dtypes", {}).get(key)
            saved_shape = meta.get("shapes", {}).get(key)
            if saved_dtype is not None and _dtype_name(arr) != saved_dtype:
                raise CheckpointError(
                    f"step_{step}: leaf {i} dtype {arr.dtype} != "
                    f"{saved_dtype} recorded in tree.json — corrupt leaf")
            if saved_shape is not None and list(arr.shape) != saved_shape:
                raise CheckpointError(
                    f"step_{step}: leaf {i} shape {tuple(arr.shape)} != "
                    f"{tuple(saved_shape)} recorded in tree.json — "
                    "corrupt leaf")
            if tuple(arr.shape) != tuple(ref.shape):
                raise CheckpointError(
                    f"step_{step}: leaf {i} shape {tuple(arr.shape)} != "
                    f"expected {tuple(ref.shape)}")
            name, want = _dtype_name(arr), _NAMES.get(ref.dtype, ref.dtype)
            if name != want:
                raise CheckpointError(
                    f"step_{step}: leaf {i} dtype {name} != expected "
                    f"{want} — refusing a silent cast")
            dev = ref.device if dev is None else torch.device(dev)
            if dev.type == "meta":
                raise ValueError(
                    f"step_{step}: leaf {i}'s target is a meta tensor; "
                    "pass devices= to place it")
            out.append(_to_tensor(arr, name).to(dev))
        return _unflatten(like, out)

    def restore_latest(self, like: Any, devices: Optional[Any] = None):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, devices)
        return step, tree, extra
