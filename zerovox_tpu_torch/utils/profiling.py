"""Profiling / timing utilities.

The port of zerovox_tpu/utils/profiling.py on PyTorch's tooling:

  - device_time(): the time of fn(*args) on the device, between two CUDA
    events around a run of calls (PyTorch returns before the card has
    finished, so a host clock without a synchronise times the enqueue).
    For tensors on the CPU it is the host clock.
  - trace(): context manager around torch.profiler; writes a Chrome trace.
  - StageTimer: named wall-clock sections that end in a device synchronise.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, List, Optional

import torch


def _on_cuda(tree) -> bool:
    """Whether a tensor somewhere in nested dicts, lists and tuples is on a card."""
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(v) for v in tree)
    return False


def device_time(fn: Callable, *args, iters: int = 10, reps: int = 3,
                cuda: Optional[bool] = None) -> float:
    """Median milliseconds per fn(*args) call over `reps` runs of `iters`
    calls each, after one warm-up call.

    On a card (cuda=True, or by default when an argument holds a CUDA
    tensor) a run is timed between two CUDA events, so the time is the
    device's from the first launch to the last kernel's end: for work whose
    launches the host issues slower than the card runs them, that is the
    host's pace.  Otherwise a run is timed on the host clock."""
    if iters < 1 or reps < 1:
        raise ValueError("iters and reps must be >= 1")
    if cuda is None:
        cuda = _on_cuda(args)
    fn(*args)
    times: List[float] = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            times.append(1e3 * (time.perf_counter() - t0) / iters)
    return statistics.median(times)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (host and, where there is a card, CUDA
    activity); yields the profiler, and on exit writes
    <logdir>/trace.json, a Chrome trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Named wall-clock sections with a printable report.  A section ends in
    a device synchronise (where there is a card), so its time holds the work
    it launched."""

    def __init__(self):
        self.records: List[tuple] = []

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.records.append((name, time.perf_counter() - t0))

    def report(self) -> str:
        total = sum(t for _, t in self.records) or 1e-12
        lines = [f"{n:30s} {t*1e3:9.2f} ms {100*t/total:5.1f}%"
                 for n, t in self.records]
        return "\n".join(lines)
