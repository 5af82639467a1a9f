"""Where a B=1 request's time goes, on the host and on the card.

    python -m zerovox_tpu_torch.tools.request_profile [--precision float32|bfloat16|both]
    python -m zerovox_tpu_torch.tools.request_profile --threads 8

For a full-length demo request at the production config (random weights
from seed 0) it prints, per precision:
  * the wall time of TTSEngine.synthesize, of the front alone with and
    without its host sync, and the front's time between two CUDA events
    (six runs each, all shown: the host clock of a shared machine spreads);
  * how long the host takes to issue the front's launches, and how long
    until the card has finished them: when the two are about equal the
    front is bound by the host's launches, not by the card;
  * a torch.profiler table of three fronts (kernel time by operator); the
    kernel rows' count and time over three are the launches and the card's
    busy time per front; the idle share of the front is 1 - busy / the
    front's time between events;
  * the wall of a whole stream of the same request (chunk 64, overlap 16).

With --threads N it prints instead, per precision, what N Python threads
that each issue B=1 fronts cost beside one thread doing the same (the
serving daemon runs one handler thread per connection, all on one
interpreter and one CUDA stream): what a thread's first front costs (cuDNN's
execution plans are cached per thread, so a new thread builds them all
again), then, with every thread warm, the wall per front, how long a
front's launches take to issue inside its thread, the card's busy time per
front (torch.profiler) and the card's idle share of the wall.  Fronts that
cost the same busy time but N times the issue time are held up by the
interpreter, not by the card.
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import threading
import time

import numpy as np
import torch

from ..cli import _demo_utterance
from ..config import ZeroVoxConfig
from ..models.pipeline import compute_dtype, front, request_tensors
from ..models.streaming import StreamingSynthesizer
from ..params import init_params
from ..runtime.engine import TTSEngine


def _walls(fn, n=6):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _fmt(ts):
    return f"median {statistics.median(ts):.2f} ms ({' '.join('%.2f' % t for t in ts)})"


def threaded_fronts(run_front, n_threads: int, rounds: int = 6, lock=None):
    """`rounds` fronts from each of n_threads new threads started together,
    after each thread has run one front alone.  Returns (median ms of a
    thread's first front, to the card's end; wall ms per later front; median
    ms a later front takes to issue inside its thread; card busy ms per
    later front; idle share of that wall).  With `lock`, a thread makes a
    front's launches only while it holds it: one thread at a time, which is
    what the serving paths get from device.on_issuing_thread."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    barrier = threading.Barrier(n_threads + 1)
    warm = threading.Barrier(n_threads + 1)
    first, issued, errors = [], [], []
    turn = threading.Lock()

    def worker():
        try:
            with turn:                  # first fronts one thread at a time, each timed alone
                t0 = time.perf_counter()
                run_front()
                torch.cuda.synchronize()
                first.append(1e3 * (time.perf_counter() - t0))
            warm.wait(timeout=120)
            barrier.wait(timeout=120)
            for _ in range(rounds):
                with lock or contextlib.nullcontext():
                    t0 = time.perf_counter()
                    run_front()
                    issued.append(1e3 * (time.perf_counter() - t0))  # list.append is atomic
        except Exception as e:          # noqa: BLE001  (reported below)
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_threads)]
    for t in threads:
        t.start()
    warm.wait(timeout=300)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"front threads failed or hung: {errors[:3]}")
    averages = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
            else "self_cuda_time_total")
    busy = sum(getattr(e, attr) for e in averages if e.device_type == DeviceType.CUDA) / 1e3
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    n = n_threads * rounds
    return statistics.median(first), wall / n, statistics.median(issued), busy / n, 1 - busy / wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", choices=("float32", "bfloat16", "both"), default="both")
    ap.add_argument("--threads", type=int, default=0, metavar="N",
                    help="report N threads issuing B=1 fronts beside one thread, and nothing else")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("request_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = ZeroVoxConfig()
    params = init_params(cfg, seed=0, device="cuda")
    src, pun, style, lens = _demo_utterance(cfg)
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    for prec in (("float32", "bfloat16") if args.precision == "both" else (args.precision,)):
        engine = TTSEngine(params, cfg, precision=prec)
        engine.warmup()
        s_, p_, sty, nph = request_tensors(engine.cfg, engine.device, src, pun, style, lens)
        sty = sty.to(compute_dtype(engine.cfg))

        @torch.inference_mode()
        def run_front():
            """The engine's front (pipeline.front on its params), no host sync."""
            return front(engine.params, engine.cfg, s_, p_, sty, nph)

        if args.threads:
            run_front()
            turns = [(1, False), (args.threads, False), (args.threads, True),
                     (args.threads, True), (args.threads, False), (1, False)]
            for n, locked in turns:
                first_ms, per, issue_ms, busy_ms, idle = threaded_fronts(
                    run_front, n, lock=threading.Lock() if locked else None)
                print(f"{prec} {n} new thread(s){', one issuing at a time' if locked else ''}: a "
                      f"thread's first front {first_ms:.2f} ms (median, each alone); then x 6 "
                      f"fronts: wall {per:.2f} ms per front "
                      f"({1e3 / per:.0f} fronts/s), a front issued in {issue_ms:.2f} ms inside its "
                      f"thread (median), card busy {busy_ms:.2f} ms per front, card idle "
                      f"{100 * idle:.0f} % of the wall", flush=True)
            continue
        print(f"{prec} synthesize wall: {_fmt(_walls(lambda: engine.synthesize(src, pun, style, lens)))}")
        print(f"{prec} front + mel_len fetch: {_fmt(_walls(lambda: run_front()[1].cpu()))}")
        print(f"{prec} front, no fetch, then sync: {_fmt(_walls(run_front))}")
        events = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run_front()
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end))
        print(f"{prec} front between CUDA events: {_fmt(events)}")
        issue, done = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_front()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            issue.append(1e3 * (t1 - t0))
            done.append(1e3 * (time.perf_counter() - t0))
        print(f"{prec} front: host issues its launches in {_fmt(issue)}; the card is done after "
              f"{_fmt(done)}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run_front()
            torch.cuda.synchronize()
        attr = ("self_device_time_total" if hasattr(prof.key_averages()[0], "self_device_time_total")
                else "self_cuda_time_total")           # the name before torch 2.4
        # kernel rows only: an operator's row repeats the time of the kernels it launched
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(getattr(e, attr) for e in kernels) / 3e3
        launched = sum(e.count for e in kernels) / 3
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=14,
                                        max_name_column_width=56))
        print(f"{prec} front: {launched:.0f} kernels and copies per front, card busy {busy:.2f} ms "
              f"per front (profiler, three fronts); idle "
              f"share of the front {100 * (1 - busy / statistics.median(events)):.0f} % of "
              f"{statistics.median(events):.2f} ms between events", flush=True)
        stream = StreamingSynthesizer(params, engine.cfg, chunk_frames=64, overlap=16)
        stream.warmup()
        print(f"{prec} whole stream: "
              f"{_fmt(_walls(lambda: np.concatenate(list(stream.stream(src, pun, style, lens)), axis=1)))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
