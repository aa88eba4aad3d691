"""Structured timing and device profiling.

Counterpart of lmic_tpu/utils/profiling.py:

- `Timings` / `timed`: named wall-clock sections with a structured
  report, used around encode/decode splits and training steps.
- `device_trace(logdir)`: a `torch.profiler` session over CPU and CUDA
  activities that writes a Chrome trace (chrome://tracing, Perfetto)
  under `logdir`: per-kernel device time, launches and host gaps.
- `annotate(name)`: a named range inside such a trace.

CUDA work is queued, so a wall-clock section around it measures the
queueing unless it waits for the device: a section synchronizes the CUDA
device of every tensor in its `sync` tree before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator

import torch


def _cuda_devices(tree: Any, out: set) -> set:
    """The CUDA devices of the tensors in a tree of dicts, lists and
    tuples."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def synchronize(tree: Any) -> None:
    """Wait for the work queued on the CUDA device of every tensor in
    `tree`; CPU tensors need nothing."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)


class Timings:
    """Accumulates named wall-clock sections: `with t.section("enc"): ...`"""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }

    def __str__(self) -> str:
        lines = [
            f"{name:>24s}: {v['total_s']:8.3f}s total"
            f"  ({v['count']}x, {v['mean_s'] * 1e3:7.2f} ms avg)"
            for name, v in sorted(self.report().items())
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Trace the block with torch.profiler (CPU and, where there is a
    card, CUDA activities) and write the Chrome trace to
    `logdir/trace-<ns>.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range inside a device trace (torch.profiler.record_function)."""
    with torch.profiler.record_function(name):
        yield


def timed(fn, *args, sync: bool = True, **kwargs):
    """One-shot: returns (result, seconds), after waiting for the CUDA
    devices of the result's tensors."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        synchronize(out)
    return out, time.perf_counter() - t0
