"""The traced part of a window: `torch.profiler` with CPU and CUDA
activities, reduced to what the per-layer readers and the result line's
`device` and `breakdown` take.

From the device's kernels and copies: the busy time (the union of their
intervals), the traced window (from the profiler's start to its stop,
after a synchronise), the top device ops by summed time, and each of the
port's kernels' launches and device seconds. Every idle stretch of the
device longer than 10 us is charged to the host op that was running when
it began (the innermost CPU event then open); shorter ones are summed
under `gaps_under_10_us`.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from port_bench.work import kernel_of

GAP_US = 10.0


@dataclass
class TraceSummary:
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    kernel_device_s: Dict[str, float] = field(default_factory=dict)


class Tracer:
    """start() and stop() around the traced part; `summary` after stop()."""

    def __init__(self) -> None:
        self.prof = None
        self.summary: Optional[TraceSummary] = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.summary = summarise(self.prof.events(), window_s)
        self.prof = None


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarise(events, window_s: float, top: int = 10) -> TraceSummary:
    """`events`: the profiler's FunctionEvents (times in us)."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        (device if e.device_type == DeviceType.CUDA else host).append(e)
    out = TraceSummary(window_s=window_s)
    by_name: Dict[str, float] = {}
    spans = []
    for e in device:
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
        k, launch = kernel_of(e.name)
        if k is not None:
            out.kernel_device_s[k] = out.kernel_device_s.get(k, 0.0) + (t - s) / 1e6
            out.kernel_launches[k] = out.kernel_launches.get(k, 0) + int(launch)
    busy = _merge(spans)
    out.busy_s = sum(e - s for s, e in busy) / 1e6
    out.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out.idle_gaps = _idle_gaps(busy, host)[:top]
    return out


def _idle_gaps(busy: List[Tuple[float, float]], host) -> List[Tuple[str, float]]:
    """Seconds of device idleness by the host op open when each gap began."""
    ops = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host),
                 key=lambda r: r[0])
    starts = [r[0] for r in ops]
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        us = b - a
        if us <= 0:
            continue
        if us < GAP_US:
            name = "gaps_under_10_us"
        else:
            name = "host:idle"
            i = bisect.bisect_right(starts, a) - 1
            # the innermost open op: the latest-starting one still running
            for j in range(i, max(-1, i - 512), -1):
                if ops[j][1] > a:
                    name = ops[j][2]
                    break
        gaps[name] = gaps.get(name, 0.0) + us / 1e6
    return sorted(gaps.items(), key=lambda kv: -kv[1])
