"""Op-level cost analysis: the port's counterpart of
``repro.launch.hlo_analysis``.

The JAX package reads a step's costs off its compiled HLO: it walks the
call graph, scales loop bodies by their trip counts, counts dot and
convolution FLOPs, and sums the result bytes of materialising
instructions and of the collectives the SPMD partitioner inserted.  A
torch program has no HLO and, in one process, no partitioner; what it has
is its stream of aten ops, which :func:`analyse_ops` watches while the step
runs (on any device; on the meta device nothing is allocated or computed,
the counterpart of lowering ``jax.ShapeDtypeStruct`` arguments):

- ``flops``: products only (mm, addmm, bmm, baddbmm, convolution and
  scaled-dot-product attention, their backward ops included when the step
  differentiates), by ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``), as ``_dot_flops``/``_conv_flops`` count dots and
  convolutions only;
- ``bytes``: the result bytes of every materialising op, a write-once
  proxy for memory traffic.  Views, aliases, ``detach``, in-place and
  ``out=`` ops write no new tensor and count nothing, as ``_NO_TRAFFIC``
  skips them in HLO; so does an allocation that writes nothing
  (``empty``).  Eager torch materialises every op where XLA fuses
  elementwise chains, so these bytes are not XLA's: only
  ``bytes_floor <= bytes`` holds both ways;
- ``bytes_floor``: the step's argument plus output bytes, the traffic
  every implementation pays;
- ``peak_live_bytes``: the most bytes of storages the step created alive
  at once (outputs included while they are built), by the storages' own
  lifetimes: the counterpart of ``memory_analysis().temp_size_in_bytes``;
- ``collective_bytes`` None and ``collectives`` empty: one process runs
  the whole step, so nothing crosses a device boundary to count;
- ``ops``: per aten op, its count, FLOPs and bytes (the saved artefact, in
  place of the HLO text).

Loop trip counts need no parsing: every iteration is dispatched.  A
hand-written kernel called through ``ctypes`` dispatches no aten op and is
invisible here, as the JAX analyser counts a Pallas ``custom-call`` as
nothing; the dry run therefore counts on the meta device, where every
kernel entry runs its plain version.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ops that allocate without writing: no traffic
_NO_WRITE = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "lift_fresh_copy")
_PLAIN = frozenset((int, float, bool, str, type(None), torch.dtype,
                    torch.device, torch.layout, torch.memory_format))


class _Unkeyed(Exception):
    pass


def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _aliases(func) -> bool:
    """Whether ``func``'s schema says a result aliases an input (a view,
    an in-place or an ``out=`` op)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _sig(args: Any) -> Tuple:
    """A hashable signature of a sequence of arguments: a meta tensor's
    shape, strides and dtype, a plain value with its type (1, 1.0 and True
    differ), a list or tuple element by element; anything else (a tensor
    off the meta device) is not keyed."""
    out = []
    for x in args:
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                raise _Unkeyed
            out.append((x.shape, x.stride(), x.dtype))
        elif type(x) in _PLAIN:
            out.append((type(x), x))
        elif isinstance(x, (list, tuple)):
            out.append(_sig(x))
        else:
            raise _Unkeyed
    return tuple(out)


def _flops(func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry

    fn = flop_registry.get(func.overloadpacket)
    return int(fn(*args, **kwargs, out_val=out)) if fn is not None else 0


class _Ops(TorchDispatchMode):
    """Counts each aten op's calls, FLOPs and result bytes, and tracks the
    bytes of the storages it creates while they live.

    FLOPs come from ``torch.utils.flop_counter``'s formulas (those of
    ``FlopCounterMode``).  A result writes new bytes unless the schema
    says it aliases an input or it shares an input's storage
    (``_unsafe_view``).  On the meta device an op's results depend only
    on its arguments' shapes, strides and dtypes, so a second call with
    the same signature rebuilds the results from the first one's (empty
    meta tensors of the same shapes and strides) instead of running the
    op's meta function again: that Python reference is most of a meta
    op's time, and a step repeats a few hundred signatures many times.

    A storage is alive while any tensor holds it.  The mode keeps one
    reference to each storage it saw created and reads its use count: at
    1 only that reference is left.  Dead storages are swept only when an
    allocation could set a new peak (the running total, dead storages
    included, bounds the live bytes from above)."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, Dict[str, int]] = {}
        self.memo: Dict[Any, Tuple[List[Tuple], Any, int]] = {}
        self.live: Dict[int, Tuple[Any, int]] = {}
        self.live_bytes = 0
        self.peak = 0

    def _sweep(self) -> None:
        for key, (st, nb) in list(self.live.items()):
            if torch._C._storage_Use_Count(st._cdata) <= 1:
                del self.live[key]
                self.live_bytes -= nb

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st._cdata in self.live:
            return
        nb = st.nbytes()
        self.live[st._cdata] = (st, nb)
        self.live_bytes += nb
        if self.live_bytes > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.live_bytes)

    def _run(self, func, args, kwargs) -> Tuple[Any, Optional[List], int]:
        """Run the op: (results, their (shape, stride, dtype) if they are
        all new tensors else None, FLOPs)."""
        out = func(*args, **kwargs)
        flops = _flops(func, args, kwargs, out)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if _aliases(func) or not all(isinstance(t, torch.Tensor)
                                     for t in outs):
            return out, None, flops
        seen = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        if any(t.untyped_storage()._cdata in seen for t in outs):
            return out, None, flops
        return out, [(t.shape, t.stride(), t.dtype) for t in outs], flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            key = (func, _sig(args),
                   _sig(sorted(kwargs.items())) if kwargs else ())
        except _Unkeyed:
            key = None
        hit = self.memo.get(key) if key is not None else None
        if hit is not None:
            metas, kind, flops = hit
            outs = [torch.empty_strided(shp, st, dtype=dt, device="meta")
                    for shp, st, dt in metas]
            out = outs[0] if kind is None else kind(outs)
        else:
            out, metas, flops = self._run(func, args, kwargs)
            seq = isinstance(out, (tuple, list))
            outs = out if seq else (out,)
            if (key is not None and metas is not None
                    and all(t.device.type == "meta" for t in outs)):
                self.memo[key] = (metas, type(out) if seq else None, flops)
        name = func.overloadpacket.__name__
        row = self.ops.setdefault(name, {"count": 0, "flops": 0, "bytes": 0})
        row["count"] += 1
        row["flops"] += flops
        if metas is not None and name not in _NO_WRITE:
            for t in outs:
                row["bytes"] += t.numel() * t.element_size()
                self._track(t)
        return out


def analyse_ops(fn: Callable[..., Any], *args: Any, **kwargs: Any
                ) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under the counters and return its
    costs (see the module docstring); ``fn``'s result is dropped."""
    counter = _Ops()
    with counter:
        out = fn(*args, **kwargs)
    floor = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
    del out
    ops = counter.ops.values()
    return {
        "flops": float(sum(r["flops"] for r in ops)),
        "bytes": float(sum(r["bytes"] for r in ops)),
        "bytes_floor": float(floor),
        "peak_live_bytes": float(counter.peak),
        "collective_bytes": None,
        "collectives": {},
        "ops": dict(sorted(counter.ops.items())),
    }
