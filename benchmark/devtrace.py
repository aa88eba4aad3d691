"""The traced run: torch.profiler over the measured window, kept in
memory, reduced to device busy time, kernel time by name and the idle
gaps by what the host was doing.

Host activity is named by the `record_function` ranges the drivers put
around each call into the program (`SPANS`); the window itself is the
range `window`.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional

import torch

SPANS = ("train_step", "compress_async", "finalize", "decompress_async",
         "pixels", "batch_feed")


def span(name: str, on: bool):
    """A record_function range when tracing, else nothing."""
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


class Summary:
    """What the readers and the result line take from a trace."""

    def __init__(self, busy_s, window_s, kernels, gaps):
        self.busy_s = busy_s
        self.window_s = window_s
        # {kernel name: (seconds, records)}
        self.kernels: Dict[str, List[float]] = kernels
        # {host activity: idle seconds}
        self.gaps: Dict[str, float] = gaps

    def top_kernels(self, k=10):
        items = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return [[name, sec] for name, (sec, _) in items]

    def top_gaps(self, k=10):
        items = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:k]
        return [[name, sec] for name, sec in items]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof) -> Optional[Summary]:
    """The Summary of a profiler session whose window is the `window`
    range; None when the trace holds no window or no device operation."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window, host, dev = None, [], []
    for ev in events:
        name = ev.name()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                dev.append((ev.start_ns(), ev.end_ns(), name))
        elif name == "window":
            window = (ev.start_ns(), ev.end_ns())
        elif name in SPANS:
            host.append((ev.start_ns(), ev.end_ns(), name))
    if window is None or not dev:
        return None
    w0, w1 = window
    kernels = defaultdict(lambda: [0.0, 0])
    clipped = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        k = kernels[name[:120]]
        k[0] += (e - s) / 1e9
        k[1] += 1
    busy = _union(clipped)
    busy_s = sum(e - s for s, e in busy) / 1e9
    host.sort()
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while j < len(host) and host[j][1] < a:
            j += 1
        what = "other host work"
        for s, e, name in host[j:]:
            if s > mid:
                break
            if e >= mid:
                what = name
        gaps[what] += (b - a) / 1e9
    return Summary(busy_s, (w1 - w0) / 1e9, dict(kernels), dict(gaps))


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
