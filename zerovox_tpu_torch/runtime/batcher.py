"""Dynamic request batching: coalesce concurrent one-shot requests.

The port of zerovox_tpu/runtime/batcher.py, with the same policy.  A serving
daemon sees many concurrent independent requests, each a B=1 dispatch whose
front is bound by the host issuing its launches, and the launches of all of
them are issued by one thread (device.on_issuing_thread): N concurrent requests cost N
fronts of host time whatever the card does.  Coalescing them makes one
front at B <= the engine's ladder top out of N: what it buys is the
per-dispatch host work shared over the batch, and what it costs is card
time (see below).  Measured on an H100 (PERF.md): 1.5-2.0 times the
requests/s of 8 closed-loop clients in bfloat16; in float32 between a
fifth less and a quarter more, with the host's pace.

`DynamicBatcher` is continuous batching with a fill window: a request
enqueues and blocks; a dispatcher thread pops compatible requests (up to
the engine's ladder top) and makes ONE `synthesize_async` dispatch,
ladder-padded, so the set of shapes stays the set warmup() ran.  A lone
request on an idle daemon dispatches at once (no added wait); coalescing
comes from requests that arrive while a dispatch is being issued, plus up to
`window_ms` of extra fill time that only applies when the engine was
already busy.

Dispatch and fetch are pipelined: the dispatcher hands each batch's fetch()
closure to a small completion pool and forms the next batch at once, so
batch k+1 is issued while batch k computes or is copied to the host.  A
fetch() waits on CUDA events (device.wait_host), which releases the
interpreter lock.  `max_inflight` dispatches may be in flight at once; the
semaphore doubles as backpressure: when the card is saturated the
dispatcher blocks, the queue fills, and the next batch forms larger.

`synthesize_async` vocodes at the largest bucket (it launches before
mel_len is known), so a request through the batcher costs more card time
than one past it (a 240-frame request is vocoded as 1500 frames); measured
times are in PERF.md.  "Idle" above means that the dispatcher found its
queue empty and slept: on the CPU, where a dispatch computes before it
returns, an answer can reach its client before the dispatcher is back at
its queue, and a client that asks again at once then waits out the window.

Off by default; enable with `TTSServer(batch_window_ms=...)` / the CLI's
`--batch-window-ms`.  Requests are grouped by their (trim, pcm16) flags:
only compatible requests share a dispatch.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np


class _Pending:
    __slots__ = ("src", "pun", "style", "n", "key",
                 "done", "wav", "mel_len", "size", "error")

    def __init__(self, src, pun, style, n, key):
        self.src, self.pun, self.style, self.n = src, pun, style, n
        self.key = key
        self.done = threading.Event()
        self.wav: Optional[np.ndarray] = None
        self.mel_len: Optional[int] = None
        self.size: Optional[int] = None
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    """Blocking facade over TTSEngine.synthesize_async with coalescing."""

    def __init__(self, engine, window_ms: float = 5.0,
                 max_batch: Optional[int] = None,
                 request_timeout_s: float = 120.0,
                 max_inflight: int = 3):
        self.engine = engine
        self.window_s = float(window_ms) / 1e3
        self.max_batch = int(max_batch or engine.batch_ladder[-1])
        self.request_timeout_s = float(request_timeout_s)
        self._cond = threading.Condition()
        self._queue: List[_Pending] = []
        self._stop = False
        # pipelining: bound the number of dispatched-but-unfetched batches
        # (the card's queue depth, device and pinned memory for their
        # outputs), and complete them on a pool so that fetches overlap the
        # next dispatch
        self._inflight = threading.Semaphore(max(1, int(max_inflight)))
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(max_inflight)),
                                        thread_name_prefix="zv-fetch")
        # observability (GET /metrics): dispatch count, packed request
        # count, and the largest batch actually formed
        self._stats_lock = threading.Lock()
        self.stats = {"dispatches": 0, "requests": 0, "max_batch": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="zv-batcher")
        self._thread.start()

    # ------------------------------------------------------------- request
    def synthesize(self, src, pun, style, n, trim: bool = True,
                   pcm16: bool = False) -> Tuple[np.ndarray, int]:
        """Enqueue ONE utterance (B=1 arrays) and block for its result."""
        return self.synthesize_sized(src, pun, style, n, trim, pcm16)[:2]

    def synthesize_sized(self, src, pun, style, n, trim: bool = True,
                         pcm16: bool = False) -> Tuple[np.ndarray, int, int]:
        """synthesize(), and the batch size the request was computed at:
        the ladder size its dispatch was padded to.  In bfloat16 an answer
        can depend on that size (PERF.md), so the daemon reports it."""
        item = _Pending(np.asarray(src), np.asarray(pun),
                        np.asarray(style), np.asarray(n),
                        key=(bool(trim), bool(pcm16)))
        if item.src.shape[0] != 1:
            raise ValueError("DynamicBatcher.synthesize takes one utterance "
                             "(B=1 arrays); use engine.synthesize_packed "
                             "for caller-assembled batches")
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            self._queue.append(item)
            self._cond.notify_all()
        if not item.done.wait(timeout=self.request_timeout_s):
            # dequeue the abandoned request if the dispatcher has not
            # taken it yet: otherwise a stalled engine unwedges into
            # packed dispatches nobody is waiting on, serialized ahead
            # of the clients' retries
            with self._cond:
                if item in self._queue:
                    self._queue.remove(item)
            raise TimeoutError(f"batched synthesis did not complete in "
                               f"{self.request_timeout_s}s")
        if item.error is not None:
            raise item.error
        return item.wav, item.mel_len, item.size

    # ---------------------------------------------------------- dispatcher
    def _take_batch(self) -> List[_Pending]:
        """Block until work exists and pop one compatible batch.  Runs in
        the dispatcher thread.

        Policy: if the dispatcher had to SLEEP (the engine is idle), take
        what is there at once: a lone request on an idle daemon waits for
        nothing, and coalescing emerges from arrivals during its dispatch
        (continuous batching).  If requests accumulated while the engine
        was busy, window up to `window_s` more to fill the batch toward the
        ladder top before dispatching."""
        with self._cond:
            was_idle = False
            while not self._queue and not self._stop:
                was_idle = True
                self._cond.wait()
            if self._stop and not self._queue:
                return []
            key = self._queue[0].key
            if not was_idle:
                deadline = time.monotonic() + self.window_s
                while not self._stop:
                    n_match = sum(1 for q in self._queue if q.key == key)
                    left = deadline - time.monotonic()
                    if n_match >= self.max_batch or left <= 0:
                        break
                    self._cond.wait(timeout=left)
            batch = [q for q in self._queue if q.key == key][: self.max_batch]
            for q in batch:
                self._queue.remove(q)
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                # An empty batch is NOT always shutdown: the windowing
                # cond.wait releases the lock, so a request that hits its
                # client-side timeout can dequeue itself mid-window and
                # leave nothing matching the captured key.  Only exit when
                # stop was requested and the queue is drained; otherwise go
                # back to waiting.
                with self._cond:
                    drained = self._stop and not self._queue
                if not drained:
                    continue
                # stopped and drained; wait for in-flight completions
                self._pool.shutdown(wait=True)
                return
            self._inflight.acquire()
            trim, pcm16 = batch[0].key
            # synthesize_async splits at the ladder top and pads each chunk
            top = self.engine.batch_ladder[-1]
            for i, q in enumerate(batch):
                q.size = self.engine.ladder_size(min(top, len(batch) - i // top * top))
            try:
                fetch = self.engine.synthesize_async(
                    np.concatenate([q.src for q in batch]),
                    np.concatenate([q.pun for q in batch]),
                    np.concatenate([q.style for q in batch]),
                    np.concatenate([q.n for q in batch]),
                    trim=trim, pcm16=pcm16)
            except BaseException as e:     # dispatch failed: deliver now
                self._inflight.release()
                self._finish(batch, error=e)
                if not isinstance(e, Exception):
                    raise                  # interrupt / exit: not ours to keep
                continue
            self._pool.submit(self._complete, batch, fetch)

    def _complete(self, batch: List[_Pending], fetch):
        """Completion-pool worker: block on the fetch, deliver results."""
        error = None
        try:
            wavs, mel_len = fetch()
            for i, q in enumerate(batch):
                q.wav, q.mel_len = wavs[i], int(mel_len[i])
        except BaseException as e:         # deliver failures to the waiters
            error = e
        finally:
            self._inflight.release()
        self._finish(batch, error=error)
        if error is not None and not isinstance(error, Exception):
            raise error                    # interrupt / exit: not ours to keep

    def _finish(self, batch: List[_Pending], error=None):
        if error is not None:
            for q in batch:
                q.error = error
        with self._stats_lock:
            self.stats["dispatches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["max_batch"] = max(self.stats["max_batch"],
                                          len(batch))
        for q in batch:
            q.done.set()

    def snapshot(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)

    def stop(self):
        """Stop accepting requests; the dispatcher drains what's queued."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=self.request_timeout_s)
