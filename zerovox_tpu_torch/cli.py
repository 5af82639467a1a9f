"""Command-line interface: GGUF checkpoint -> WAV synthesis, one-shot or as
the HTTP serving daemon (--serve).

Input JSON format (one utterance, arrays padded or not):
  {"phonemes": [69, 26, ...], "puncts": [0, 1, ...], "style": [528 floats]}

Usage:
  python -m zerovox_tpu_torch.cli --model model.gguf --input utt.json --output out.wav
  python -m zerovox_tpu_torch.cli --model model.gguf --demo --output out.wav
  python -m zerovox_tpu_torch.cli --model model.gguf --demo --precision bfloat16 \\
      --stream --output out.wav
  python -m zerovox_tpu_torch.cli --model model.gguf --input long.json --split-long
  python -m zerovox_tpu_torch.cli --model model.gguf --demo --device cpu
  python -m zerovox_tpu_torch.cli --model model.gguf --serve --port 8765 \\
      --precision bfloat16 [--batch-window-ms 5] [--allow-reload] [--mesh 4,1]

Runs on the card (--device cuda, the default) unless asked for the CPU.
--precision bfloat16 is the serving dtype; --stream vocodes in chunks and
writes each to the WAV file as it arrives (the TTFA line on stderr is the
time to the first chunk on disk); --split-long takes an utterance longer
than max_n_phonemes, split at punctuation.  --serve runs the daemon of
runtime/server.py (runtime/client.py talks to it) until SIGTERM or Ctrl-C,
then drains and exits 0; with --mesh DATA,MODEL it serves over DATA x MODEL
distinct CUDA devices (MODEL=1: pure data parallelism; MODEL>1: tensor
parallelism), and raises where the machine has fewer.  --compile-cache DIR
keeps the compiled libraries (the MRF kernel, the native loader) in DIR.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# flags of the JAX package's CLI whose paths later slices of the port bring
_NOT_PORTED = ("verify",)


def _load_utterance(path: str, cfg):
    from zerovox_tpu_torch.runtime.utterance import utterance_from_dict
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"cannot read utterance file {path}: {e}")
    try:
        return utterance_from_dict(d, cfg)
    except ValueError as e:
        raise SystemExit(f"{path}: {e}")


def _demo_utterance(cfg, seed: int = 0):
    """The JAX CLI's demo utterance, drawn the same way from the same seed."""
    rng = np.random.default_rng(seed)
    P = cfg.max_n_phonemes
    src = rng.integers(1, cfg.num_phonemes + 1, size=(1, P)).astype(np.int32)
    pun = rng.integers(0, cfg.num_puncts + 1, size=(1, P)).astype(np.int32)
    style = rng.normal(scale=0.05, size=(1, cfg.d_model)).astype(np.float32)
    return src, pun, style, np.asarray([P], np.int32)


def _serve(args, params, cfg, buckets, mesh) -> int:
    """Run the daemon until SIGTERM or Ctrl-C, then drain and return 0."""
    import signal
    import threading

    from zerovox_tpu_torch.runtime.server import TTSServer
    server = TTSServer(params, cfg, host=args.host, port=args.port,
                       precision=args.precision, mel_buckets=buckets,
                       chunk_frames=args.chunk_frames, overlap=args.overlap,
                       batch_window_ms=args.batch_window_ms,
                       allow_reload=args.allow_reload,
                       max_concurrent=args.max_concurrent, device=args.device,
                       mesh=mesh)
    host, port = server.address
    print(f"serving on http://{host}:{port} "
          "(/healthz /metrics /synthesize /batch /stream"
          + (" /reload" if args.allow_reload else "") + ")",
          file=sys.stderr, flush=True)
    # orchestrators stop containers with SIGTERM: drain cleanly instead of
    # dying with a traceback.  The handler only UNBLOCKS serve_forever, from
    # a helper thread (stopping it on the thread that serves deadlocks); the
    # main thread then performs the drain (close the listener, stop the
    # batcher after it finishes queued work), so the process cannot exit
    # before the drain runs.
    signal.signal(signal.SIGTERM,
                  lambda *_: threading.Thread(target=server.stop_serving,
                                              daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    server.shutdown()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zerovox_tpu_torch",
                                 description="zerovox TTS on PyTorch/CUDA")
    ap.add_argument("--model", required=True, help="GGUF checkpoint path")
    ap.add_argument("--input", help="utterance JSON (phonemes/puncts/style)")
    ap.add_argument("--demo", action="store_true",
                    help="synthesize a random demo utterance")
    ap.add_argument("--output", default="out.wav", help="output WAV path")
    ap.add_argument("--precision", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--stream", action="store_true",
                    help="use the streaming chunked vocoder")
    ap.add_argument("--chunk-frames", type=int, default=64)
    ap.add_argument("--overlap", type=int, default=16)
    ap.add_argument("--buckets", default="256,512,1024",
                    help="comma-separated mel-length buckets")
    ap.add_argument("--no-trim", action="store_true",
                    help="keep the full padded waveform (reference behavior)")
    ap.add_argument("--split-long", action="store_true",
                    help="accept utterances longer than max_n_phonemes by "
                         "splitting at punctuation into one packed batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu for the "
                         "plain PyTorch path)")
    ap.add_argument("--serve", action="store_true",
                    help="run the HTTP serving daemon instead of one-shot "
                         "synthesis (endpoints: /healthz /metrics /synthesize "
                         "/batch /stream)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="with --serve: coalesce concurrent /synthesize "
                         "requests arriving within this window into one "
                         "packed device dispatch. 0 = off")
    ap.add_argument("--max-concurrent", type=int, default=64,
                    help="with --serve: max in-flight synthesis/stream "
                         "requests; excess answers 503 + Retry-After "
                         "(fast load shedding)")
    ap.add_argument("--allow-reload", action="store_true",
                    help="with --serve: enable POST /reload, which hot-swaps "
                         "weights from a new same-geometry GGUF without "
                         "restarting (admin-plane deployments only)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="with --serve: multi-device serving over a mesh of "
                         "DATA x MODEL CUDA devices.  MODEL=1: pure DP (each "
                         "device runs the whole pipeline on its batch slice; "
                         "pairs with --batch-window-ms).  MODEL>1: tensor-"
                         "parallel (channel-sharded front, time-sharded "
                         "vocoder: one utterance spread across devices)")
    ap.add_argument("--compile-cache", metavar="DIR",
                    help="keep the compiled libraries (the MRF kernel's nvcc builds, the "
                         "native loader) under DIR: a restarted process finds them built")
    for flag in _NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), nargs="?", const=True,
                        default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    for flag in _NOT_PORTED:
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is not yet ported to "
                             "zerovox_tpu_torch; use python -m zerovox_tpu.cli")

    if args.compile_cache:
        from zerovox_tpu_torch.utils.compile_cache import enable_compile_cache
        print(f"compile cache: {enable_compile_cache(args.compile_cache)}", file=sys.stderr)

    from zerovox_tpu_torch.io.wav import StreamingWavWriter, write_wav
    from zerovox_tpu_torch.params import load_params
    from zerovox_tpu_torch.runtime.engine import TTSEngine

    t0 = time.perf_counter()
    try:
        cfg, params = load_params(args.model, device=args.device)
    except FileNotFoundError:
        raise SystemExit(f"model checkpoint not found: {args.model}")
    except (ValueError, EOFError, KeyError) as e:
        raise SystemExit(f"cannot load {args.model}: {e}")
    print(f"loaded {args.model} ({time.perf_counter()-t0:.2f}s): "
          f"d_model={cfg.d_model} max_seq_len={cfg.max_seq_len} "
          f"sr={cfg.sampling_rate} device={args.device}", file=sys.stderr)
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)

    if args.serve:
        mesh = None
        if args.mesh:
            from zerovox_tpu_torch.parallel import make_mesh, parse_mesh_spec
            try:
                d, m = parse_mesh_spec(args.mesh)
            except ValueError as e:
                ap.error(str(e))
            if args.device == "cpu":
                ap.error("--mesh spans CUDA devices; it does not run with --device cpu")
            mesh = make_mesh(data=d, model=m)
        return _serve(args, params, cfg, buckets, mesh)

    if args.split_long:
        if not args.input:
            ap.error("--split-long needs --input (a JSON utterance)")
        from zerovox_tpu_torch.runtime.longform import split_utterance, synthesize_long
        from zerovox_tpu_torch.runtime.utterance import parse_utterance_arrays
        try:
            with open(args.input) as f:
                ph, pu, style = parse_utterance_arrays(json.load(f), cfg)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            raise SystemExit(f"{args.input}: {e}")
        if not args.stream:
            engine = TTSEngine(params, cfg, mel_buckets=buckets, precision=args.precision,
                               device=args.device)
            t0 = time.perf_counter()
            wav, mel_len = synthesize_long(engine, ph, pu, style)
            print(f"synthesized {len(ph)} phonemes as {len(mel_len)} windows "
                  f"({time.perf_counter()-t0:.2f}s incl. first-call set-up)", file=sys.stderr)
            write_wav(args.output, wav, cfg.sampling_rate)
            print(f"wrote {args.output}: {len(wav)} samples "
                  f"({len(wav)/cfg.sampling_rate:.2f}s @ {cfg.sampling_rate} Hz)")
            return 0
        # streaming long-form: each window streams in turn into the sink
        srcs, puns, lens = split_utterance(ph, pu, cfg.max_n_phonemes)
        windows = [(srcs[i:i + 1], puns[i:i + 1], style, lens[i:i + 1])
                   for i in range(len(lens))]
    elif args.input:
        windows = [_load_utterance(args.input, cfg)]
    elif args.demo:
        windows = [_demo_utterance(cfg)]
    else:
        ap.error("one of --input / --demo is required")

    if args.stream:
        from zerovox_tpu_torch.models.streaming import StreamingSynthesizer
        if args.precision == "bfloat16":
            cfg = cfg.replace(compute_dtype="bfloat16")
        s = StreamingSynthesizer(params, cfg, chunk_frames=args.chunk_frames,
                                 overlap=args.overlap, device=args.device)
        t0 = time.perf_counter()
        # each chunk is flushed to disk the moment it arrives, so the time
        # to first audio is real at the file boundary
        with StreamingWavWriter(args.output, cfg.sampling_rate) as sink:
            first = True
            for wsrc, wpun, wstyle, wn in windows:
                for chunk in s.stream(wsrc, wpun, wstyle, wn):
                    sink.write(chunk)
                    if first:
                        first = False
                        print(f"TTFA {1e3*(time.perf_counter()-t0):.1f} ms "
                              f"(incl. first-call set-up; first "
                              f"{sink.samples_written} samples on disk)", file=sys.stderr)
            total = sink.samples_written
        print(f"wrote {args.output}: {total} samples "
              f"({total/cfg.sampling_rate:.2f}s @ {cfg.sampling_rate} Hz, streamed)")
        return 0

    src, pun, style, n = windows[0]
    engine = TTSEngine(params, cfg, mel_buckets=buckets, precision=args.precision,
                       device=args.device)
    t0 = time.perf_counter()
    wavs, mel_len = engine.synthesize(src, pun, style, n, trim=not args.no_trim)
    print(f"synthesized {int(mel_len[0])} mel frames "
          f"({time.perf_counter()-t0:.2f}s incl. first-call set-up)",
          file=sys.stderr)
    wav = wavs[0]
    if len(wav) == 0:
        print("warning: predicted durations were all zero (untrained model?) "
              "— output is empty; use --no-trim to keep the padded buffer",
              file=sys.stderr)
    write_wav(args.output, wav, cfg.sampling_rate)
    print(f"wrote {args.output}: {len(wav)} samples "
          f"({len(wav)/cfg.sampling_rate:.2f}s @ {cfg.sampling_rate} Hz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
