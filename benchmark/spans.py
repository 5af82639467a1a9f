"""Reading the program's span recorder (zerovox_tpu_torch.utils.profiling
RECORDER): the spans and counters that the daemon, the batcher, the issuing
thread and the engine recorded, for the per-layer metrics that read them.

The recorder stamps its entries on the profiler's clock (time.time_ns), the
clock of a traced pass's window (ctx.trace.window) and device intervals, so
a reader selects entries by that window and lays spans over kernels as they
are.  A program without the recorder gives None here, and so does every
reader built on it: a traced run of such a program reports its other
metrics.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from benchmark import trace

# the issuing thread launching (device.on_issuing_thread's named runs)
ISSUED = ("issue.front", "issue.vocode", "issue.stream")
# what a handler thread waits on, inside its daemon.request: the issuing
# thread (its queue and its launches) and the card (engine.sync)
WAITS = ("issue.wait",) + ISSUED + ("engine.sync",)


def recorder():
    """The program's recorder, or None where it has none."""
    try:
        from zerovox_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "RECORDER", None)


def ring() -> Optional[list]:
    """Every entry the ring holds, oldest first; None without a recorder."""
    rec = recorder()
    return None if rec is None else rec.entries()


def totals() -> Optional[dict]:
    """The recorder's per-name totals of the process; None without one."""
    rec = recorder()
    return None if rec is None else rec.totals()


def ending_in(entries: Iterable, names: Sequence[str], window: Tuple[int, int]) -> list:
    """The entries named in `names` whose end lies in [lo, hi)."""
    lo, hi = window
    return [e for e in entries if e.name in names and lo <= e.end < hi]


def serves(entry, rid) -> bool:
    """Whether `entry` was recorded for request `rid` (alone, or among the
    requests of a batcher dispatch)."""
    return entry.rid == rid or (isinstance(entry.rid, tuple) and rid in entry.rid)


def covered_ns(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) that the union of `intervals` covers."""
    clipped = [(max(s, lo), min(e, hi)) for s, e in intervals]
    return sum(e - s for s, e in trace.union([(s, e) for s, e in clipped if e > s]))


def self_ns(span, children: Iterable) -> int:
    """The span's duration less the part of it that `children` cover."""
    return span.end - span.start - covered_ns(((c.start, c.end) for c in children),
                                              span.start, span.end)


def minus_ns(intervals: List[Tuple[int, int]], busy: List[Tuple[int, int]]) -> int:
    """Nanoseconds inside the union of `intervals` and outside that of `busy`."""
    return sum(e - s - covered_ns(busy, s, e) for s, e in trace.union(intervals))
