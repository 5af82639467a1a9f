"""End-to-end benchmark on the card: the real-time factor of the full
synthesis pipeline (the port of the repository root's bench.py).

    python -m zerovox_tpu_torch.tools.bench [--f32] [--batch B] [--iters K] [--warmup N]
                                           [--no-ttfa] [--no-b8] [--no-daemon]
                                           [--tiny] [--device cpu]

Prints ONE JSON line with bench.py's keys:
  {"metric": "rtf_wall_per_audio_sec", "value": <wall seconds per audio second>,
   "unit": "s/s", "vs_baseline": <0.05 / value; > 1 beats the target>,
   "wall_ms", "spread_ms", "ttfa_p50_ms", "b8_wall_ms", "b8_rtf_per_chip",
   "daemon_p50_ms", "stream_ttfa_p50_ms",
   "card": <nvidia-smi's name and power limit>, "single_ms"}
The target is bench.py's: RTF < 0.05 (20x realtime) at the production
geometry (max_seq_len 1500 mel frames, hop 300 at 24 kHz: 18.75 s of audio
an utterance), here per card.  The timed computation is models.pipeline.
synthesize on the static 1500-frame buffer, so the RTF does not depend on
the weights (random, seed 0).  The default is the bf16 serving path;
--f32 times the parity path (TF32 off).

Timing.  wall_ms is the time per run of K back-to-back synthesize calls
between two CUDA events (utils.profiling.device_times), the median of 5
such runs; spread_ms is half their range.  The front issues its launches
with no host sync, so this is the steady-state time per run: while the
front is bound by its launches, the larger of the host's issue time and
the card's.  single_ms is the host clock of one call that ends in a host
fetch of the wav (median of 7).  The B=8 leg (default invocation only)
draws its inputs from the same generator after B=1's, as bench.py does.
TTFA is bench.py's: StreamingSynthesizer(chunk_frames=64, overlap=16),
warmup(batch=B), the median of 15 first chunks (host data when yielded).
The daemon leg runs tools.bench_daemon --reps 9 --no-batch in a subprocess
under a 1500 s timeout; if it fails, its keys are left out with a warning
on standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from . import measure


def timed_run(model, cfg, src, pun, style):
    """The benchmark's timed computation on device tensors: a function that
    runs synthesize once and returns its wav (B, max_seq_len * hop)."""
    from ..models.pipeline import synthesize

    @torch.inference_mode()
    def run():
        return synthesize(model.params, cfg, src, pun, style, device=model.device,
                          packed=model.packed).wav
    return run


def wall_per_run(run, K: int, runs: int, cuda: bool):
    """ms per run of K back-to-back calls, for each of `runs` such runs."""
    from ..utils.profiling import device_times
    return device_times(run, iters=K, reps=runs, cuda=cuda)


def measure_ttfa(model, cfg, src, pun, style, chunk_frames=64, overlap=16, reps=15):
    """p50 seconds to the first audio chunk of the streaming path (after its warm-up)."""
    from ..models.streaming import StreamingSynthesizer
    s = StreamingSynthesizer(model, cfg, chunk_frames=chunk_frames, overlap=overlap,
                             device=model.device)
    s.warmup(batch=src.shape[0])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        next(s.stream(src, pun, style))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_daemon(device: str, tiny: bool, timeout_s=1500):
    """Socket-level /synthesize p50 and /stream TTFA p50 (seconds) from a live
    daemon: tools.bench_daemon in a subprocess with its own timeout, so that
    a daemon that hangs costs this leg and not the benchmark's line.  Its
    mrf_launches line is passed on to standard error."""
    r = subprocess.run(
        [sys.executable, "-m", "zerovox_tpu_torch.tools.bench_daemon", "--reps", "9",
         "--no-batch", "--device", device] + (["--tiny"] if tiny else []),
        capture_output=True, text=True, timeout=timeout_s, cwd=measure.ROOT,
        env=dict(os.environ))
    if r.returncode != 0:
        raise RuntimeError(f"bench_daemon rc={r.returncode}: {r.stderr[-300:]}")
    for line in re.findall(r"^.*mrf_launches .*$", r.stderr, re.M):
        print(f"bench: daemon leg: {line}", file=sys.stderr, flush=True)
    out = json.loads(r.stdout.strip().splitlines()[-1])
    return out["synthesize_p50_ms"] / 1e3, out["stream_ttfa_p50_ms"] / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true", help="benchmark the float32 parity path")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--ttfa", action="store_true",
                    help="(kept for compatibility; TTFA is always measured)")
    ap.add_argument("--fuse-a", action="store_true",
                    help="not in the port: the JAX package's a>1 in-kernel upsample option")
    ap.add_argument("--no-ttfa", action="store_true",
                    help="skip the streaming time-to-first-audio measurement")
    ap.add_argument("--no-b8", action="store_true", help="skip the B=8 throughput leg")
    ap.add_argument("--no-daemon", action="store_true", help="skip the daemon latency leg")
    measure.add_device_flags(ap)
    args = ap.parse_args(argv)
    if args.iters < 2:
        ap.error("--iters must be >= 2 (bench.py's limit: its runs are chains of K calls)")
    if args.fuse_a:
        ap.error("--fuse-a: the port has no vocoder_fuse_a_upsample (a TPU layout option; "
                 "the port's MRF kernel always runs the upsample inside the stage)")
    dev = measure.start(args.device)

    from ..models.pipeline import load_model
    from ..params import init_params

    dtype_name = "float32" if args.f32 else "bfloat16"
    cfg = measure.model_config(args.tiny, dtype_name)
    model = load_model(init_params(cfg, seed=0, device=dev), cfg, dev)
    cuda = dev.type == "cuda"
    card = measure.card_line(dev)

    B = args.batch
    rng = np.random.default_rng(0)
    src_h, pun_h, style_h = measure.draw_inputs(cfg, B, rng)
    run = timed_run(model, cfg, *measure.on_device(dev, src_h, pun_h, style_h))
    K = args.iters
    print(f"bench: device={card} dtype={dtype_name} B={B} T={cfg.max_seq_len} "
          f"audio={cfg.audio_seconds:.2f}s/utt", file=sys.stderr)

    t0 = time.perf_counter()
    run().cpu()
    print(f"bench: first run (kernel build, packing, cuDNN's choices) "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
    for _ in range(args.warmup * K):
        run()
    t_single = []
    for _ in range(7):
        t0 = time.perf_counter()
        run().cpu()
        t_single.append(time.perf_counter() - t0)
    single = float(np.median(t_single))
    est = [ms / 1e3 for ms in wall_per_run(run, K, 5, cuda)]
    wall = float(np.median(est))
    spread = (max(est) - min(est)) / 2
    audio = cfg.audio_seconds * B
    rtf = wall / audio
    print(f"bench: single (ends in the wav's host fetch) {single*1e3:.1f} ms; {K}-call runs -> "
          f"wall/run {wall*1e3:.2f} ms (+/- {spread*1e3:.2f})", file=sys.stderr)
    print(f"bench: median wall {wall*1e3:.2f} ms for {audio:.2f} s audio "
          f"-> RTF {rtf:.5f} ({1.0/rtf:.1f}x realtime)", file=sys.stderr)

    # the B=8 leg on the default invocation only, as bench.py
    b8_wall = None
    if args.batch == 1 and not args.no_b8 and not args.f32:
        run8 = timed_run(model, cfg, *measure.on_device(dev, *measure.draw_inputs(cfg, 8, rng)))
        t0 = time.perf_counter()
        run8().cpu()
        print(f"bench: B=8 first run {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        est8 = [ms / 1e3 for ms in wall_per_run(run8, K, 3, cuda)]
        b8_wall = float(np.median(est8))
        print(f"bench: B=8 wall/run {b8_wall*1e3:.2f} ms "
              f"(+/- {(max(est8)-min(est8))/2*1e3:.2f}) -> "
              f"RTF/card {b8_wall/(cfg.audio_seconds*8):.6f}", file=sys.stderr)

    ttfa = None
    if not args.no_ttfa:
        ttfa = measure_ttfa(model, cfg, src_h, pun_h, style_h)
        print(f"bench: p50 TTFA {ttfa*1e3:.1f} ms (chunk 64 frames = 0.8 s audio, the "
              f"CLI/daemon default; target < 100 ms)", file=sys.stderr)
    measure.report_launches("bench", dtype_name)

    daemon = None
    if args.batch == 1 and not args.no_daemon and not args.f32:
        try:
            daemon = measure_daemon(args.device, args.tiny)
            print(f"bench: daemon /synthesize p50 {daemon[0]*1e3:.1f} ms, "
                  f"/stream TTFA p50 {daemon[1]*1e3:.1f} ms (HTTP included)", file=sys.stderr)
        except (RuntimeError, OSError, subprocess.SubprocessError, ValueError, KeyError,
                IndexError) as e:
            # bench.py's rule: the benchmark still prints its line
            print(f"bench: daemon leg failed ({type(e).__name__}: {e}); "
                  "omitting daemon keys", file=sys.stderr)

    out = {
        "metric": "rtf_wall_per_audio_sec",
        "value": round(rtf, 6),
        "unit": "s/s",
        "vs_baseline": round(0.05 / rtf, 2),
        "wall_ms": round(wall * 1e3, 2),
        "spread_ms": round(spread * 1e3, 2),
    }
    if ttfa is not None:
        out["ttfa_p50_ms"] = round(ttfa * 1e3, 1)
    if b8_wall is not None:
        out["b8_wall_ms"] = round(b8_wall * 1e3, 2)
        out["b8_rtf_per_chip"] = round(b8_wall / (cfg.audio_seconds * 8), 6)
    if daemon is not None:
        out["daemon_p50_ms"] = round(daemon[0] * 1e3, 1)
        out["stream_ttfa_p50_ms"] = round(daemon[1] * 1e3, 1)
    out["card"] = card
    out["single_ms"] = round(single * 1e3, 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
