"""Command-line interface: GGUF checkpoint -> WAV synthesis (one-shot mode).

Input JSON format (one utterance, arrays padded or not):
  {"phonemes": [69, 26, ...], "puncts": [0, 1, ...], "style": [528 floats]}

Usage:
  python -m zerovox_tpu_torch.cli --model model.gguf --input utt.json --output out.wav
  python -m zerovox_tpu_torch.cli --model model.gguf --demo --output out.wav
  python -m zerovox_tpu_torch.cli --model model.gguf --demo --device cpu

Runs on the card (--device cuda, the default) unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# flags of the JAX package's CLI whose paths later slices of the port bring
_NOT_PORTED = ("stream", "serve", "split_long", "verify", "mesh", "compile_cache")


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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zerovox_tpu_torch",
                                 description="zerovox TTS on PyTorch/CUDA")
    ap.add_argument("--model", required=True, help="GGUF checkpoint path")
    ap.add_argument("--input", help="utterance JSON (phonemes/puncts/style)")
    ap.add_argument("--demo", action="store_true",
                    help="synthesize a random demo utterance")
    ap.add_argument("--output", default="out.wav", help="output WAV path")
    ap.add_argument("--buckets", default="256,512,1024",
                    help="comma-separated mel-length buckets")
    ap.add_argument("--no-trim", action="store_true",
                    help="keep the full padded waveform (reference behavior)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu for the "
                         "plain PyTorch path)")
    for flag in _NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), nargs="?", const=True,
                        default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    for flag in _NOT_PORTED:
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is not yet ported to "
                             "zerovox_tpu_torch; use python -m zerovox_tpu.cli")

    from zerovox_tpu_torch.io.wav import write_wav
    from zerovox_tpu_torch.params import load_params
    from zerovox_tpu_torch.runtime.engine import TTSEngine

    if not (args.input or args.demo):
        ap.error("one of --input / --demo is required")

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

    src, pun, style, n = (_load_utterance(args.input, cfg) if args.input
                          else _demo_utterance(cfg))
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    engine = TTSEngine(params, cfg, mel_buckets=buckets, device=args.device)
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
