"""A short traced window: a few training steps under ``torch.profiler``,
read into device operations (name, start, end), the device's busy time,
and the idle gaps by what the host was doing.

Recording the host's operators slows the host by some microseconds an
operator, which a step of tens of thousands of operators feels: the
device then waits more than it does untraced.  So the device's numbers
come from a window traced with the CUDA activity alone, and the idle gaps'
host operators from one more step traced with both.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable

import torch


@dataclasses.dataclass
class Trace:
    ops: list          # device operations: (name, start_us, end_us)
    window_s: float    # host clock around the traced steps
    span_s: float      # first device operation's start to last one's end
    busy_s: float      # union of the device operations' intervals
    gaps: list         # (host operator at the gap, seconds) per idle gap

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for name, start, end in self.ops:
            total[name] = total.get(name, 0.0) + (end - start) / 1e6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        total: dict = {}
        for name, secs in self.gaps:
            total[name] = total.get(name, 0.0) + secs
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]


def _events(prof):
    """(device ops, host ops) as (name, start_us, end_us) lists, from the
    profiler's raw events."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        item = (e.name(), start, start + e.duration_ns() / 1e3)
        (dev if e.device_type() == cuda else host).append(item)
    return dev, host


def union_us(ops: list) -> tuple[float, list]:
    """(total length of the union of the ops' intervals, the idle gaps
    between them as (start, end))."""
    spans = sorted((s, e) for _, s, e in ops)
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0] if spans else (0.0, 0.0)
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if spans:
        busy += cur_e - cur_s
    return busy, gaps


#: Host operators looked at, back from a gap, for one that covers it.
_SCAN = 2000


def _host_at(host: list, starts: list, at: float) -> str:
    """The innermost host operator running at ``at`` (the latest start that
    still covers it) in ``host`` sorted by start, or "python" where none
    does."""
    i = bisect.bisect_right(starts, at)
    for name, s, e in reversed(host[max(i - _SCAN, 0):i]):
        if e > at:
            return name
    return "python"


def traced(steps: int, run_step: Callable[[], None], host: bool) -> Trace:
    """Run ``run_step`` ``steps`` times under the profiler and read the
    trace; with ``host``, the CPU activity is recorded too and each idle gap
    is named by the host operator it fell in.  The profiler now and then
    records no device operation; then the caller gets a trace with no
    ops."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, ops = _events(prof)
    busy, gaps = union_us(dev)
    span = (max(e for _, _, e in dev) - min(s for _, s, _ in dev)
            if dev else 0.0)
    named = []
    if host:
        ops.sort(key=lambda h: h[1])
        starts = [h[1] for h in ops]
        named = [(_host_at(ops, starts, s), (e - s) / 1e6) for s, e in gaps]
    return Trace(dev, window, span / 1e6, busy / 1e6, named)
