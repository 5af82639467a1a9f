"""Where a B=1 request's time goes, on the host and on the card.

    python -m zerovox_tpu_torch.tools.request_profile [--precision float32|bfloat16|both]

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
Needs a card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", choices=("float32", "bfloat16", "both"), default="both")
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
