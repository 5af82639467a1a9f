"""The traced sub-windows: torch.profiler over a few steady seconds, reduced
to device intervals and the breakdown.

The metrics' pass records the card's activity alone (kernels, copies, sets
and the CUDA runtime calls that CUPTI reports): recording the CPU
operations of the launch-bound issuing thread slows the daemon, and its
readings would describe a slower program.  A shorter pass after it records
the CPU operations too, only to name the breakdown's idle gaps by what the
host was doing.  Everything here is read from the profiler's raw events
(start, end, name, device), clipped to the pass's window, which is bounded
by the host's clock (time.time_ns, the profiler's own clock) read right
after the profiler started and right before it stopped.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

# the CUDA runtime's and driver's calls (every other host event is an operation)
RUNTIME_PREFIXES = ("cuda", "cu")


class Event(NamedTuple):
    name: str
    start: int        # ns, the profiler's clock
    end: int


class TraceData(NamedTuple):
    window: Tuple[int, int]     # ns
    device: List[Event]         # kernels, copies, sets
    host_ops: List[Event]       # CPU operations (aten ops, user annotations)
    runtime: List[Event]        # CUDA runtime and driver calls

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


class Profiler:
    """start() / stop() around a pass; stop() returns the TraceData.

    cpu: record the CPU operations too (the naming pass), besides the card's
    activity.  PyTorch's profiler records the CPU operations of the thread
    that starts it, so it is started and stopped on the program's issuing
    thread of the device (zerovox_tpu_torch.device.on_issuing_thread), where
    every launch of the daemon is made; the runtime calls and the card's
    events are recorded whatever the thread."""

    def __init__(self, device, cpu: bool):
        from torch.profiler import ProfilerActivity, profile
        from zerovox_tpu_torch.device import on_issuing_thread
        acts = ([ProfilerActivity.CPU] if cpu or device.type != "cuda" else []) + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self._prof = profile(activities=acts, record_shapes=False, with_stack=False,
                             profile_memory=False)
        self._on = lambda fn: on_issuing_thread(device, fn)
        self._t0 = 0

    def start(self):
        self._on(self._prof.start)
        self._t0 = time.time_ns()

    def stop(self) -> TraceData:
        t1 = time.time_ns()
        self._on(self._prof.stop)
        t2 = time.time_ns()
        out = reduce_events(self._prof.profiler.kineto_results.events(), (self._t0, t1))
        self.costs = {"stop_s": (t2 - t1) / 1e9, "reduce_s": (time.time_ns() - t2) / 1e9}
        return out


def _annotation(e) -> bool:
    """A user annotation the profiler mirrors on the device's timeline."""
    fn = getattr(e, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


def reduce_events(events, window: Tuple[int, int]) -> TraceData:
    """Sort the profiler's raw events into device, host-op and runtime lists,
    each clipped to the window (events wholly outside it are dropped)."""
    lo, hi = window
    dev, ops, rt = [], [], []
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= lo or s >= hi or t < s:
            continue
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if _annotation(e):                   # a span over kernels, not work
                continue
            out = dev
        else:
            out = rt if name.startswith(RUNTIME_PREFIXES) else ops
        out.append(Event(name, max(s, lo), min(t, hi)))
    return TraceData(window, dev, ops, rt)


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(trace: TraceData) -> int:
    """Nanoseconds of the window in which some kernel, copy or set ran."""
    return sum(e - s for s, e in union([(d.start, d.end) for d in trace.device]))


def idle_share(trace: TraceData) -> Optional[float]:
    """Percent of the window with nothing running on the card; None when the
    trace holds no device event (nothing to read)."""
    if not trace.device:
        return None
    span = trace.window[1] - trace.window[0]
    return 100.0 * (1.0 - busy_ns(trace) / span)


def gaps(trace: TraceData) -> List[Tuple[int, int]]:
    """The idle intervals of the window, longest first."""
    lo, hi = trace.window
    busy = union([(d.start, d.end) for d in trace.device])
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def host_op_at(trace: TraceData, t: int) -> str:
    """The innermost host operation (the shortest one) running at time t,
    among CPU operations and runtime calls; "(no op)" where none runs."""
    best: Optional[Event] = None
    for e in trace.host_ops + trace.runtime:
        if e.start <= t < e.end and (best is None or e.end - e.start < best.end - best.start):
            best = e
    return best.name if best is not None else "(no op)"


def device_time_by_name(trace: TraceData) -> Dict[str, float]:
    """Seconds of device time per operation name."""
    out: Dict[str, float] = {}
    for d in trace.device:
        out[d.name] = out.get(d.name, 0.0) + (d.end - d.start) / 1e9
    return out


def breakdown(trace: TraceData, named: Optional[TraceData] = None, n: int = 10) -> dict:
    """The `n` device operations of `trace` that took most time and the `n`
    longest idle gaps of `named` (the naming pass; `trace` where there is
    none), each named by the host operation that spans its middle."""
    named = trace if named is None else named
    ops = sorted(device_time_by_name(trace).items(), key=lambda kv: -kv[1])[:n]
    idle = [[host_op_at(named, (s + e) // 2), (e - s) / 1e9] for s, e in gaps(named)[:n]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
