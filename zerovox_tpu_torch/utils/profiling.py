"""Profiling / timing utilities.

The port of zerovox_tpu/utils/profiling.py on PyTorch's tooling:

  - device_time(): the time of fn(*args) on the device, between two CUDA
    events around a run of calls (PyTorch returns before the card has
    finished, so a host clock without a synchronise times the enqueue).
    For tensors on the CPU it is the host clock.  device_times(): each
    run's time, for a spread.
  - trace(): context manager around torch.profiler; writes a Chrome trace.
  - the span recorder (RECORDER; span(), count(), record(), enable()): when
    and on which thread each step of a request ran, for the daemon's layers
    (its handlers, the batcher, the issuing thread, the engine's waits and
    the vocoder's frames).  Every entry is stamped on the clock of
    torch.profiler's events (time.time_ns), so a span and a kernel of one
    profiled pass compare without conversion, and the Chrome events of
    chrome_trace() lie in the range of a trace() file's.

A span is an interval on one thread: its name, start, end, thread, its own
id, the request it serves and the id of the span that caused it (the
innermost span open in the context that opened it).  A counter is an entry
with one or two values and no duration.  The request id and the open span
live in context variables: device.submit_on_issuing_thread runs a function
in a copy of the caller's context, so what the issuing thread records for a
request carries that request's id and names the caller's span as its cause.
Entries go into a bounded ring (the last RING_SIZE of them, whatever their
age); per-name totals (count, nanoseconds, summed values) are kept for the
life of the process, so set-up spans outlive the ring.  The recorder is off
until enable() (TTSServer turns it on as its first step); entering and
leaving a span reads the clock twice and takes one lock, never synchronises
the card and never calls the profiler.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

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
    calls each, after one warm-up call (device_times).

    On a card (cuda=True, or by default when an argument holds a CUDA
    tensor) a run is timed between two CUDA events, so the time is the
    device's from the first launch to the last kernel's end: for work whose
    launches the host issues slower than the card runs them, that is the
    host's pace.  Otherwise a run is timed on the host clock."""
    return statistics.median(device_times(fn, *args, iters=iters, reps=reps, cuda=cuda))


def device_times(fn: Callable, *args, iters: int = 10, reps: int = 3,
                 cuda: Optional[bool] = None) -> List[float]:
    """Milliseconds per fn(*args) call in each of `reps` runs of `iters`
    calls, after one warm-up call, timed as device_time says."""
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
    return times


@contextlib.contextmanager
def trace(logdir: str, with_stack: bool = False):
    """torch.profiler over the block (host and, where there is a card, CUDA
    activity); yields the profiler, and on exit writes
    <logdir>/trace.json, a Chrome trace (chrome://tracing, Perfetto).
    with_stack: the Python frames of the host lanes too, so that an
    operator (and the kernels it launched) can be traced to its source line."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ------------------------------------------------------------------- spans

CLOCK = "time.time_ns"      # torch.profiler's clock: its events' start_ns() read on it
now = time.time_ns
RING_SIZE = 1 << 17         # entries: over 60 s of the serving daemon's traffic (PERF.md)
# libkineto's Chrome traces give times from the start of the current
# 7,889,238-second interval (ChromeTraceBaseTime); chrome_trace() does too
_CHROME_BASE_S = 7889238

_request: contextvars.ContextVar = contextvars.ContextVar("zv_request", default=None)
_span: contextvars.ContextVar = contextvars.ContextVar("zv_span", default=None)
_request_ids = itertools.count(1)
_local = threading.local()


def thread_id() -> int:
    """The calling thread's OS id (threading.get_native_id), read once per
    thread: it is a system call, several microseconds where system calls
    are trapped (PERF.md)."""
    tid = getattr(_local, "tid", None)
    if tid is None:
        tid = _local.tid = threading.get_native_id()
    return tid


class Entry(NamedTuple):
    """One recorded span or counter."""
    name: str
    start: int            # ns, time.time_ns (the profiler's clock)
    end: int              # ns; == start for a counter
    thread: int           # the OS thread id (thread_id()), as the profiler's tid
    id: int               # the entry's own id
    rid: object           # the request id, a tuple of them (a batcher dispatch), or None
    cause: Optional[int]  # the id of the span that caused this one
    a: object = None      # values: a counter's integers; daemon.request's endpoint
    b: object = None


class SpanRecorder:
    """The ring of entries and the per-name totals.  Thread-safe: every
    entry is added under one lock."""

    def __init__(self, size: int = RING_SIZE):
        if size < 1:
            raise ValueError("the ring holds at least one entry")
        self.on = False
        self.size = int(size)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * self.size
        self._n = 0
        self._totals: Dict[str, list] = {}
        self._threads: Dict[int, str] = {}

    def new_id(self) -> int:
        return next(self._ids)

    def add(self, name: str, start: int, end: int, sid: int, rid=None, cause=None,
            a=None, b=None, thread: Optional[int] = None):
        """Add one finished entry (whatever `on` says: the callers check)."""
        own = thread is None
        if own:
            thread = thread_id()
        entry = (name, start, end, thread, sid, rid, cause, a, b)
        with self._lock:
            self._ring[self._n % self.size] = entry
            self._n += 1
            t = self._totals.get(name)
            if t is None:
                t = self._totals[name] = [0, 0, 0, 0]
            t[0] += 1
            t[1] += end - start
            if type(a) is int:
                t[2] += a
            if type(b) is int:
                t[3] += b
            if own and thread not in self._threads:
                self._threads[thread] = threading.current_thread().name

    @property
    def added(self) -> int:
        """Entries added (the ring holds the last `size` of them)."""
        return self._n

    def entries(self, lo: Optional[int] = None, hi: Optional[int] = None) -> List[Entry]:
        """The ring's entries in the order they were added; with lo and hi,
        those that overlap [lo, hi) (a counter: stamped in it)."""
        with self._lock:
            n, ring = self._n, list(self._ring)
        if n > self.size:
            ring = ring[n % self.size:] + ring[:n % self.size]
        else:
            ring = ring[:n]
        out = []
        for e in ring:
            if lo is not None and (e[2] < lo or (e[2] == lo and e[1] < lo)):
                continue
            if hi is not None and e[1] >= hi:
                continue
            out.append(Entry(*e))
        return out

    def totals(self) -> Dict[str, dict]:
        """Per name: count, total_ns and the summed integer values a and b."""
        with self._lock:
            return {k: {"count": c, "total_ns": ns, "a": a, "b": b}
                    for k, (c, ns, a, b) in self._totals.items()}

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._threads)


RECORDER = SpanRecorder()


def enable(on: bool = True):
    """Turn the process's recorder on (TTSServer does, first) or off."""
    RECORDER.on = bool(on)


def new_request() -> int:
    """A fresh request id."""
    return next(_request_ids)


def request_id():
    """The request id of the calling context (None outside a request)."""
    return _request.get()


def current_span() -> Optional[int]:
    """The id of the innermost span open in the calling context."""
    return _span.get()


class Span:
    """One span, as a context manager: entering stamps its start and makes
    it the cause of what the block records; leaving stamps its end and, if
    the recorder is on, records it.  `start`, `end` and `seconds` are read
    whether or not it is on (the daemon times its requests by them).

    rid: the request id the block serves (set for the block's context);
    by default the context's.  cause: the causing span's id; by default the
    innermost span open in the context."""

    __slots__ = ("name", "rid", "cause", "a", "b", "id", "start", "end", "_tokens")

    def __init__(self, name: str, rid=None, cause: Optional[int] = None, a=None, b=None):
        self.name, self.rid, self.cause, self.a, self.b = name, rid, cause, a, b
        self.start = self.end = 0

    def __enter__(self):
        self.id = RECORDER.new_id()
        if self.cause is None:
            self.cause = _span.get()
        if self.rid is None:
            self.rid = _request.get()
            self._tokens = (_span.set(self.id), None)
        else:
            self._tokens = (_span.set(self.id), _request.set(self.rid))
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        span_token, request_token = self._tokens
        _span.reset(span_token)
        if request_token is not None:
            _request.reset(request_token)
        if RECORDER.on:
            RECORDER.add(self.name, self.start, self.end, self.id, self.rid, self.cause,
                         self.a, self.b)
        return False

    @property
    def seconds(self) -> float:
        return max(0, self.end - self.start) / 1e9


class _Off:
    """What span() returns while the recorder is off: does nothing."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, rid=None, cause: Optional[int] = None, a=None, b=None):
    """A Span while the recorder is on, else a context manager that does
    nothing."""
    return Span(name, rid, cause, a, b) if RECORDER.on else _OFF


def count(name: str, a: int, b: Optional[int] = None):
    """A counter entry: one or two values, stamped now, in the calling
    context's request and span."""
    if RECORDER.on:
        t = time.time_ns()
        RECORDER.add(name, t, t, RECORDER.new_id(), _request.get(), _span.get(), a, b)


def record(name: str, start: int, end: int, rid=None, cause: Optional[int] = None,
           thread: Optional[int] = None, a=None, b=None):
    """A span whose two ends were stamped apart (on two threads, such as a
    request's wait in a queue): recorded with the stamps given, on `thread`
    (by default the calling one)."""
    if RECORDER.on:
        RECORDER.add(name, start, end, RECORDER.new_id(), rid, cause, a, b, thread)


def issued(name: str, fn: Callable) -> Callable:
    """fn, wrapped for running on an issuing thread: the wait from now until
    it starts is recorded as "issue.wait" on the calling thread, and its run
    as the span `name` (device.submit_on_issuing_thread)."""
    if not RECORDER.on:
        return fn
    t_submit, caller, rid, cause = time.time_ns(), thread_id(), _request.get(), _span.get()

    def run(*args, **kwargs):
        record("issue.wait", t_submit, time.time_ns(), rid, cause, caller)
        with span(name):
            return fn(*args, **kwargs)

    return run


def _quantile(sorted_values: List[int], q: float):
    if not sorted_values:
        return None
    return sorted_values[min(len(sorted_values) - 1, int(q * len(sorted_values)))]


def summary(recorder: Optional[SpanRecorder] = None) -> dict:
    """What GET /trace answers: the clock, the per-name totals (with p50
    and p95 of the durations of the entries in the ring), the thread
    names and the ring's entries."""
    rec = recorder or RECORDER
    ring = rec.entries()
    durations: Dict[str, List[int]] = {}
    for e in ring:
        durations.setdefault(e.name, []).append(e.end - e.start)
    totals = {}
    for name, t in rec.totals().items():
        d = sorted(durations.get(name, ()))
        p50, p95 = _quantile(d, 0.50), _quantile(d, 0.95)
        totals[name] = {**t, "in_ring": len(d),
                        "p50_ms": None if p50 is None else p50 / 1e6,
                        "p95_ms": None if p95 is None else p95 / 1e6}
    return {"clock": CLOCK, "on": rec.on, "ring_size": rec.size, "added": rec.added,
            "totals": totals, "threads": {str(k): v for k, v in rec.thread_names().items()},
            "fields": list(Entry._fields), "entries": [list(e) for e in ring]}


def chrome_trace(recorder: Optional[SpanRecorder] = None) -> dict:
    """The ring as Chrome trace events (chrome://tracing, Perfetto): spans
    as complete events, counters as counter events, in microseconds from
    the base libkineto gives its own traces (baseTimeNanoseconds), on the
    OS thread ids the profiler uses, so that they lie beside a trace()
    file's events in one timeline."""
    rec = recorder or RECORDER
    pid = os.getpid()
    base = time.time_ns() // 10**9 // _CHROME_BASE_S * _CHROME_BASE_S * 10**9
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": name}}
              for tid, name in rec.thread_names().items()]
    for e in rec.entries():
        args = {"id": e.id, "rid": e.rid, "cause": e.cause}
        if e.start == e.end and type(e.a) is int:        # a counter
            events.append({"ph": "C", "name": e.name, "pid": pid, "tid": e.thread,
                           "ts": (e.start - base) / 1e3,
                           "args": {"a": e.a} if e.b is None else {"a": e.a, "b": e.b}})
            continue
        if e.a is not None:
            args["a"] = e.a
        if e.b is not None:
            args["b"] = e.b
        events.append({"ph": "X", "cat": "zerovox", "name": e.name, "pid": pid, "tid": e.thread,
                       "ts": (e.start - base) / 1e3, "dur": (e.end - e.start) / 1e3,
                       "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms", "baseTimeNanoseconds": base}
