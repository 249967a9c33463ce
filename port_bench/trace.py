"""The traced window: ``torch.profiler`` over CPU and CUDA activity, then
reduced to what the per-layer metrics and the breakdown read.

Busy time is the union of the device's operation spans and launches are
the kernel-launch API calls (``cudaLaunchKernel``, ``cudaLaunchKernelExC``
for cluster launches, and the driver's ``cuLaunchKernel(Ex)``), the
arithmetic of ``benchmarks_torch/adapt_profile.py`` copied here.  Idle
gaps are charged to the innermost host operation running at the gap's
midpoint."""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Any, Dict, List, Tuple

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
TOP = 10
NAME_CHARS = 160  # a kernel's templated name is cut to this


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every traced event."""
    from torch.autograd import DeviceType

    out = []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            out.append((e.name(), e.device_type() == DeviceType.CUDA,
                        int(e.start_ns()), int(e.end_ns())))
    except AttributeError:
        for e in prof.events():
            out.append((e.name, e.device_type == DeviceType.CUDA,
                        int(e.time_range.start * 1000),
                        int(e.time_range.end * 1000)))
    return out


def reduce_events(events: List[Tuple[str, bool, int, int]],
                  window_s: float) -> Dict[str, Any]:
    """Busy seconds, launches, device time by operation name, and idle
    gaps by what the host was doing."""
    dev = sorted((s, e, n) for n, on_dev, s, e in events if on_dev)
    host = sorted((s, e, n) for n, on_dev, s, e in events if not on_dev)
    launches = sum(1 for _, _, n in host if n.startswith(LAUNCH_PREFIXES))
    by_name: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    busy_ns, hi = 0, None
    gaps: List[Tuple[int, int]] = []
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e9
        count[n] += 1
        if hi is not None and s > hi:
            gaps.append((hi, s))
        busy_ns += max(0, e - max(s, hi if hi is not None else s))
        hi = e if hi is None else max(hi, e)
    # the innermost host event covering each gap's midpoint
    idle: Dict[str, float] = defaultdict(float)
    heap: List[Tuple[int, int, str]] = []
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        # the latest-started event that still covers mid
        name = "no host operation"
        for neg_s, end, n in heap:
            if end >= mid:
                name = n
                break
        idle[name] += (g1 - g0) / 1e9
    return {
        "busy_s": busy_ns / 1e9, "window_s": window_s, "launches": launches,
        "device_s_by_name": dict(by_name), "device_count_by_name": dict(count),
        "device_ops": sorted(([k[:NAME_CHARS], v] for k, v in
                              by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k[:NAME_CHARS], v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


class Traced:
    """``with Traced() as t: ...`` profiles the block, its window timed on
    the host between two device synchronisations; :meth:`reduce` then
    returns :func:`reduce_events` of it (after the measured window: the
    reduction of a few hundred thousand events takes seconds)."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._sync = (torch.cuda.synchronize if torch.cuda.is_available()
                      else (lambda: None))
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> Dict[str, Any]:
        summary = reduce_events(_events(self._prof), self.window_s)
        self._prof = None
        return summary
