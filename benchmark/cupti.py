"""The card's activity over a whole run, from CUPTI's activity records.

A Collector asks CUPTI (the CUDA profiling library that torch.profiler also
reads) for one record per kernel, copy and set that runs on the card, from
any thread of the process, each with its start and end on CUPTI's clock in
nanoseconds.  Only these three kinds are enabled: no record is made of the
host's calls, so the launches of the daemon cost next to nothing more.
CUPTI hands the records over in buffers; they are kept as they come and read
only after the window has closed.  busy_s(t0, t1) is the length of the union
of the kernels' and sets' intervals within [t0, t1) on the host's monotonic
clock, mapped to CUPTI's clock by readings of both taken at start() and at
stop().  Copies are kept apart (copy_s): a copy to pageable host memory is
paced by the host's own copying, so its length follows the host's pace and
not the card's work.

torch.profiler uses the same activity records, so a run uses one or the
other: the traced runs use the profiler, and make no Collector.  Where the
library or the records are missing there is nothing to read (None).
"""

from __future__ import annotations

import ctypes
import glob
import os
import time
from typing import Dict, List, Optional, Tuple

KINDS = {1: "memcpy", 2: "memset", 10: "kernel"}   # CUpti_ActivityKind
START_AT = 16                  # byte offset of start (end follows) in each of these records
BUFFER_BYTES = 8 << 20
SUCCESS = 0
FLUSH_FORCED = 1

_u8p = ctypes.POINTER(ctypes.c_uint8)
_Request = ctypes.CFUNCTYPE(None, ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_size_t),
                            ctypes.POINTER(ctypes.c_size_t))
_Complete = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint32, _u8p, ctypes.c_size_t,
                             ctypes.c_size_t)


def _library():
    """libcupti: the copy the process has loaded already (torch's), else the
    one beside torch's CUDA libraries, else the toolkit's."""
    with open("/proc/self/maps") as f:
        loaded = sorted({ln.split()[-1] for ln in f if "libcupti" in ln and "/" in ln})
    import torch
    near = os.path.join(os.path.dirname(torch.__file__), "..", "nvidia", "cuda_cupti", "lib")
    candidates = loaded + ["libcupti.so.12", "libcupti.so"] + sorted(
        glob.glob(os.path.join(near, "libcupti.so*"))) + sorted(
        glob.glob("/usr/local/cuda/extras/CUPTI/lib64/libcupti.so*"))
    for path in candidates:
        try:
            return ctypes.CDLL(path)
        except OSError:
            continue
    raise OSError("libcupti not found")


def busy_ns(intervals: List[Tuple[int, int]], lo: float, hi: float) -> int:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, at = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, at), min(e, hi)
        if e > s:
            total += e - s
            at = e
    return int(total)


class Collector:
    """start() / stop() around a run; busy_s() after stop()."""

    def __init__(self):
        self.error: Optional[str] = None
        self.records: Dict[str, int] = {}
        self.intervals: Dict[str, List[Tuple[int, int]]] = {k: [] for k in KINDS.values()}
        self._buffers: Dict[int, ctypes.Array] = {}
        self._full: List[Tuple[int, int]] = []          # (buffer address, valid bytes)
        self._clock: List[Tuple[float, int]] = []        # (monotonic s, CUPTI ns)
        self._lib = None
        try:
            lib = _library()
            self._cbs = (_Request(self._request), _Complete(self._complete))
            rc = lib.cuptiActivityRegisterCallbacks(*self._cbs)
            if rc != SUCCESS:
                raise OSError(f"cuptiActivityRegisterCallbacks returned {rc}")
            self._lib = lib
        except Exception as e:                          # noqa: BLE001
            self.error = repr(e)

    def _request(self, buf, size, max_records):
        b = (ctypes.c_uint64 * (BUFFER_BYTES // 8))()  # 8-byte aligned, as CUPTI asks
        self._buffers[ctypes.addressof(b)] = b
        buf[0] = ctypes.cast(b, _u8p)
        size[0] = BUFFER_BYTES
        max_records[0] = 0

    def _complete(self, context, stream, buf, size, valid):
        self._full.append((ctypes.cast(buf, ctypes.c_void_p).value, valid))

    def _mark(self):
        ts = ctypes.c_uint64(0)
        self._lib.cuptiGetTimestamp(ctypes.byref(ts))
        self._clock.append((time.monotonic(), ts.value))

    def start(self):
        if self._lib is None:
            return
        for kind in KINDS:
            rc = self._lib.cuptiActivityEnable(kind)
            if rc != SUCCESS:
                self.error = f"cuptiActivityEnable({kind}) returned {rc}"
        self._mark()

    def stop(self):
        """Stop recording and read every record CUPTI holds."""
        if self._lib is None:
            return
        self._mark()
        for kind in KINDS:
            self._lib.cuptiActivityDisable(kind)
        self._lib.cuptiActivityFlushAll(FLUSH_FORCED)
        rec, after = ctypes.c_void_p(), self._lib.cuptiActivityGetNextRecord
        for addr, valid in self._full:
            rec.value = None
            buf, size = ctypes.c_void_p(addr), ctypes.c_size_t(valid)
            while after(buf, size, ctypes.byref(rec)) == SUCCESS:
                kind = KINDS.get(ctypes.c_uint32.from_address(rec.value).value)
                if kind is not None:
                    s, e = (ctypes.c_uint64 * 2).from_address(rec.value + START_AT)
                    if e > s:
                        self.intervals[kind].append((s, e))
                    self.records[kind] = self.records.get(kind, 0) + 1
            self._buffers.pop(addr, None)
        self._full.clear()
        self._buffers.clear()
        self._lib = None

    def cupti_ns(self, mono_s: float) -> float:
        """A time on the monotonic clock on CUPTI's clock: the line through
        the readings of both at start() and stop()."""
        (m0, c0), (m1, c1) = self._clock[0], self._clock[-1]
        rate = (c1 - c0) / (m1 - m0) if m1 > m0 else 1e9
        return c0 + (mono_s - m0) * rate

    def _union_s(self, kinds, t0_mono: float, t1_mono: float) -> Optional[float]:
        iv = [x for k in kinds for x in self.intervals[k]]
        if len(self._clock) < 2 or not iv or self.error:
            return None
        return busy_ns(iv, self.cupti_ns(t0_mono), self.cupti_ns(t1_mono)) / 1e9

    def busy_s(self, t0_mono: float, t1_mono: float) -> Optional[float]:
        """Seconds of [t0, t1) in which a kernel or a set ran on the card."""
        return self._union_s(("kernel", "memset"), t0_mono, t1_mono)

    def copy_s(self, t0_mono: float, t1_mono: float) -> Optional[float]:
        """Seconds of [t0, t1) in which a copy ran."""
        return self._union_s(("memcpy",), t0_mono, t1_mono)
