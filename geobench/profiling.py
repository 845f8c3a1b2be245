"""A traced part of a window: torch.profiler over CPU and CUDA activity,
reduced to what the per-layer metrics and the breakdown read.

The trace gives device operations (kernels, copies, sets) with their device
times, and host events (operators, runtime calls).  From them:
``busy_s`` (the union of the device operations' intervals), the device
time of each kernel name, the launch calls made by the host, the longest
idle stretches of the device labelled by what the host was doing, and the
device operations that took the most time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")


@dataclass
class Trace:
    window_s: float                       # host clock over the traced part
    busy_s: float                         # union of device-op intervals
    device_ops: Dict[str, float]          # device seconds by op name
    launches: int                         # host launch calls
    idle_gaps: List[Tuple[str, float]]    # (host activity, seconds), summed
    n_device_ops: int = 0
    steps: int = 0                        # steps the traced part ran
    reduce_s: float = 0.0                 # seconds spent reading the trace

    def device_seconds(self, patterns) -> float:
        """Device seconds of the ops whose name holds any of ``patterns``."""
        return sum(s for n, s in self.device_ops.items()
                   if any(p in n for p in patterns))


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:96]


def _events(prof):
    """(device ops, host events) as (name, start_ns, end_ns) lists."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
    return dev, host


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_labels(host, times):
    """For each time in ``times`` (sorted), the host event that started last
    among those running then (the innermost), or "host idle": one sweep
    with a heap keyed by start, ended events dropped lazily."""
    import heapq

    order = sorted(host, key=lambda h: h[1])
    heap, labels, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            name, s, e = order[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        labels.append(heap[0][2] if heap else "host idle")
    return labels


def capture(fn: Callable[[], int]):
    """Run ``fn`` (which returns the steps it ran) under the profiler, with
    the device idle before and synchronized after; returns the raw trace,
    which :func:`reduce` reads once the window has closed."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    sync()
    with profile(activities=activities, record_shapes=False,
                 with_stack=False) as prof:
        t0 = time.perf_counter()
        steps = fn()
        sync()
        window = time.perf_counter() - t0
    return prof, window, steps


def reduce(raw) -> Trace:
    """The :class:`Trace` of a :func:`capture`."""
    prof, window, steps = raw
    t_red = time.perf_counter()
    dev, host = _events(prof)
    ops: Dict[str, float] = {}
    for name, s, e in dev:
        ops[_short(name)] = ops.get(_short(name), 0.0) + (e - s) * 1e-9
    merged = _union([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged) * 1e-9
    launches = sum(1 for name, _, _ in host if name in LAUNCH_CALLS)
    holes = [(e0, s1) for (_, e0), (s1, _) in zip(merged[:-1], merged[1:])]
    gaps: Dict[str, float] = {}
    for (e0, s1), label in zip(holes, _host_labels(
            host, [(e0 + s1) // 2 for e0, s1 in holes])):
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-9
    return Trace(window_s=window, busy_s=busy, device_ops=ops,
                 launches=launches,
                 idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
                 n_device_ops=len(dev), steps=int(steps),
                 reduce_s=time.perf_counter() - t_red)


def breakdown(trace: Trace) -> dict:
    """The contract's optional ``breakdown``: the ten device operations that
    took most time and the ten host activities the device waited on most."""
    top = sorted(trace.device_ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps[:10]]}
