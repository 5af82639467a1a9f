"""The card's time of each segment of the synthesis pipeline, beside the
whole (the port of scripts/profile_breakdown.py).

    python -m zerovox_tpu_torch.tools.profile_breakdown [--batch 1] [--cumulative]
                                                       [--tiny] [--device cpu]

bfloat16, init_params(seed=0), each segment on random inputs of its
production shapes, timed by utils.profiling.device_time (CUDA events
around 10 calls, the median of 3 runs): the full synthesize, the mel (the
front: encoder, length regulator, decoder), the full vocoder, and the
vocoder's parts: the mel normalisation and input conv, each of the four
stages, and the output tail; then the sum of the parts and
"full - (mel + parts)".  In the port a stage's upsample runs inside its
MRF kernel (models.hifigan.vocode_stage), so the JAX script's separate
"upsample i" and "MRF stage i" segments are one segment per stage here;
the tail is the plain output conv (the JAX script's is a lane-folded one).
--cumulative times the vocoder's prefixes P1..P6 instead (input conv,
then each stage, then the tail) and their differences.

Prints the JAX script's lines, then one JSON line of the same numbers
({segment: ms, ..., "spread_ms": {segment: half the range of its 3 runs}}).
The segments, chained, are models.pipeline.front and hifigan.vocode.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import measure
from ..models import hifigan
from ..models.pipeline import front
from .bench import timed_run

STAGE_NOTE = ("(a stage is its upsample and its MRF kernel in one call: the port fuses them; "
              "the JAX script times them apart)")


def vocoder_parts(params, cfg, packed=None):
    """[(name, fn(c) -> c)] of the vocoder's segments in order: chained on a
    mel they compute hifigan.vocode(params, cfg, mel, packed) (B, wav_len, 1),
    each stage by the route vocode gives it."""
    voc = params["vocoder"]
    routes = hifigan.stage_routes(params, cfg)
    parts = [("mel-norm + input conv", lambda m: hifigan.vocoder_input(voc, cfg, m))]
    L, C = cfg.max_seq_len, voc["input_conv_w"].shape[0]
    for i, scale in enumerate(cfg.upsample_scales):
        Cout = voc["upsamples"][i]["w"].shape[0]
        name = f"upsample{i} {C}->{Cout} (L={L}) + MRF stage{i} C={Cout} (L={L * scale})"
        parts.append((name, lambda c, i=i: hifigan.vocode_stage(
            voc, cfg, i, c, routes[i], None if packed is None else packed[i])))
        L, C = L * scale, Cout
    wav_len = cfg.max_seq_len * cfg.hop_size
    parts.append(("output tail (out conv)",
                  lambda c: hifigan.vocoder_output(voc, cfg, c, wav_len)))
    return parts


def part_inputs(params, cfg, B):
    """The shape of each vocoder part's input, in vocoder_parts' order."""
    voc = params["vocoder"]
    shapes = [(B, cfg.max_seq_len, cfg.num_mels)]
    L = cfg.max_seq_len
    C = voc["input_conv_w"].shape[0]
    for i, scale in enumerate(cfg.upsample_scales):
        shapes.append((B, L, C))
        L, C = L * scale, voc["upsamples"][i]["w"].shape[0]
    shapes.append((B, L, C))
    return shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cumulative", action="store_true",
                    help="time vocoder prefixes to localize composition overhead")
    ap.add_argument("--batch", type=int, default=1)
    measure.add_device_flags(ap)
    args = ap.parse_args(argv)
    dev = measure.start(args.device)

    from ..models.pipeline import load_model
    from ..params import init_params
    from ..utils.profiling import device_times

    cfg = measure.model_config(args.tiny, "bfloat16")
    model = load_model(init_params(cfg, seed=0, device=dev), cfg, dev)
    params = model.params
    dt = torch.bfloat16
    B = args.batch
    gen = torch.Generator(device=dev).manual_seed(0)
    src, pun, style = measure.on_device(
        dev, *measure.draw_inputs(cfg, B, np.random.default_rng(0)))
    print(f"device={measure.card_line(dev)}", file=sys.stderr, flush=True)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    rows, spread = {}, {}

    @torch.inference_mode()
    def timed(name, fn, *a):
        ts = device_times(fn, *a, iters=10, reps=3, cuda=dev.type == "cuda")
        rows[name], spread[name] = float(np.median(ts)), (max(ts) - min(ts)) / 2
        return rows[name]

    def bench(name, fn, *a):
        print(f"{name:34s} {timed(name.strip(), fn, *a):8.3f} ms", flush=True)

    parts = vocoder_parts(params, cfg, model.packed)
    shapes = part_inputs(params, cfg, B)
    print(STAGE_NOTE, flush=True)
    if args.cumulative:
        mel = rand(shapes[0])
        labels = ["in_conv", *(f"stage{i}" for i in range(len(parts) - 2)), "tail"]
        prev = 0.0
        for n in range(1, len(parts) + 1):
            def prefix(m, n=n):
                for _, fn in parts[:n]:
                    m = fn(m)
                return m
            t = timed(f"P{n} (+{labels[n - 1]})", prefix, mel)
            print(f"P{n:<2d} (+{labels[n - 1]:8s}) {t:8.3f} ms   delta {t - prev:+7.3f} ms",
                  flush=True)
            prev = t
        measure.report_launches("profile_breakdown", "bfloat16")
        print(json.dumps({**rows, "spread_ms": spread, "batch": B, "precision": "bfloat16"}))
        return 0

    sty = style.to(dt)
    bench("full synthesize", timed_run(model, cfg, src, pun, style))
    bench("encoder+LR+decoder (mel)", lambda: front(params, cfg, src, pun, sty, None)[0])
    mel = rand(shapes[0])
    bench("vocoder (full)", lambda m: hifigan.vocode(params, cfg, m, model.packed), mel)
    for (name, fn), shape in zip(parts, shapes):
        bench("  " + name, fn, rand(shape))
    part_names = [name for name, _ in parts]
    total_parts = sum(rows[n] for n in part_names)
    rest = rows["full synthesize"] - rows["encoder+LR+decoder (mel)"] - total_parts
    rows["sum of vocoder parts"] = total_parts
    rows["full - (mel + parts)"] = rest
    print(f"\n{'sum of vocoder parts':34s} {total_parts:8.3f} ms")
    print(f"{'full - (mel + parts)':34s} {rest:8.3f} ms  (fusion gain / overhead)")
    measure.report_launches("profile_breakdown", "bfloat16")
    print(json.dumps({**rows, "spread_ms": spread, "batch": B, "precision": "bfloat16"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
