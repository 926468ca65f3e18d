"""Reading a ``torch.profiler`` window: the device's activity as
intervals, its union (the seconds the device was busy), the kernels by
name, and the idle gaps by what the host was doing in them.  The busy
share is the arithmetic of the program's ``chip_smoke.profile_report``,
taken here as a union of intervals so that overlapping work counts once.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

NON_KERNEL = ("Memcpy", "Memset")


@dataclasses.dataclass
class TraceSummary:
    window_s: float                      # host wall of the traced slice
    busy_s: float                        # union of device activity
    n_kernels: int                       # kernel launches the device ran
    kernel_s: Dict[str, float]           # device seconds by kernel name
    idle_gaps: List[Tuple[str, float]]   # idle seconds by host op, largest first

    def kernel_seconds(self, fragments) -> float:
        """Device seconds of the kernels whose name holds any of ``fragments``."""
        return sum(sec for name, sec in self.kernel_s.items()
                   if any(f in name for f in fragments))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in self.idle_gaps[:top]]}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_op_at(starts, spans, t: int) -> str:
    """The innermost host op running at ``t`` (the latest-starting one that
    covers it), looked for among the nearest 64 that started before."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 64), -1):
        s, e, name = spans[j]
        if e >= t:
            return name
    return "host: no op"


def summarize(prof, window_s: float) -> TraceSummary:
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    kernel_s: Dict[str, float] = defaultdict(float)
    n_kernels = 0
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((s, s + d))
            name = e.name()
            if not name.startswith(NON_KERNEL):
                kernel_s[name] += d / 1e9
                n_kernels += 1
        elif d > 0:
            host.append((s, s + d, e.name()))
    busy = _union(dev)
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gaps[_host_op_at(starts, host, (e0 + s1) // 2)] += (s1 - e0) / 1e9
    return TraceSummary(window_s=window_s, busy_s=sum(e - s for s, e in busy) / 1e9,
                        n_kernels=n_kernels, kernel_s=dict(kernel_s),
                        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))
