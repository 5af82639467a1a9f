"""The card's time of each segment of mel production: encoder -> length
regulator -> StyleTTS decoder, and the decoder's own parts (the port of
scripts/profile_mel.py).

    python -m zerovox_tpu_torch.tools.profile_mel [--tiny] [--device cpu]

bfloat16, B=1, init_params(seed=0); each segment on random inputs of its
production shapes (its time depends on the shapes, not on the values),
timed by utils.profiling.device_time (CUDA events around 10 calls, the
median of 3 runs).  Prints the JAX script's lines, "<segment> <ms> ms",
then one JSON line {segment: ms, ..., "spread_ms": {segment: half the
range of its 3 runs}}.  The segments, chained on real activations, are
models.pipeline.front and styletts_decoder.decode.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import measure
from ..models import fs2_encoder, styletts_decoder
from ..ops import conv1d, durations_from_log, instance_norm, length_regulate


def length_regulator(cfg, features, log_dur):
    """durations_from_log + length_regulate: (hidden at max_seq_len, mel_len)."""
    dur = durations_from_log(log_dur, cfg.max_seq_len)
    return length_regulate(features, dur, cfg.max_seq_len)


def encode_blocks(params, cfg, hidden):
    """The decoder's two ResBlk1d."""
    x = styletts_decoder.res_blk1d(hidden, params["decoder"]["encode0"], cfg)
    return styletts_decoder.res_blk1d(x, params["decoder"]["encode1"], cfg)


def asr_branch(params, cfg, hidden):
    """The asr_res branch: a 1x1 conv and an instance norm."""
    a = params["decoder"]["asr_res"]
    return instance_norm(conv1d(hidden, a["conv_w"], a["conv_b"]), a["norm_g"], a["norm_b"],
                         eps=cfg.instance_norm_eps)


def adain_stack(params, cfg, x, asr, style):
    """The five AdainResBlk1d, asr re-concatenated before the first three."""
    dd = params["decoder"]
    for name in ("decode0", "decode1", "decode2"):
        x = torch.cat([x, asr], dim=-1)
        x = styletts_decoder.adain_res_blk1d(x, style, dd[name], cfg)
    x = styletts_decoder.adain_res_blk1d(x, style, dd["decode3"], cfg)
    return styletts_decoder.adain_res_blk1d(x, style, dd["decode4"], cfg)


def out_conv(params, cfg, x):
    o = params["decoder"]["to_out"]
    return conv1d(x, o["conv_w"], o["conv_b"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    measure.add_device_flags(ap)
    args = ap.parse_args(argv)
    dev = measure.start(args.device)

    from ..models.pipeline import load_model
    from ..params import init_params
    from ..utils.profiling import device_times

    cfg = measure.model_config(args.tiny, "bfloat16")
    params = load_model(init_params(cfg, seed=0, device=dev), cfg, dev).params
    dt = torch.bfloat16
    B, T = 1, cfg.max_seq_len
    rng = np.random.default_rng(0)
    src, pun, style = measure.on_device(dev, *measure.draw_inputs(cfg, B, rng))
    style = style.to(dt)
    print(f"device={measure.card_line(dev)}", file=sys.stderr, flush=True)

    def rand(*shape, dtype=dt):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=dev)

    rows, spread = {}, {}

    @torch.inference_mode()
    def bench(name, fn, *args):
        ts = device_times(fn, *args, iters=10, reps=3, cuda=dev.type == "cuda")
        rows[name.strip()] = float(np.median(ts))
        spread[name.strip()] = (max(ts) - min(ts)) / 2
        print(f"{name:40s} {rows[name.strip()]:8.3f} ms", flush=True)

    bench("encoder (FFT stack + variance)", fs2_encoder.encode, params, cfg, src, pun, style)
    feats = rand(B, cfg.max_n_phonemes, cfg.d_model)
    log_dur = rand(B, cfg.max_n_phonemes, dtype=torch.float32)
    bench("length regulator", length_regulator, cfg, feats, log_dur)
    hidden = rand(B, T, cfg.d_model)
    bench("styletts decoder (full)", styletts_decoder.decode, params, cfg, hidden, style)

    dd = params["decoder"]
    hdim = dd["encode1"]["conv2_w"].shape[0]
    bench(f"  2x ResBlk1d {cfg.d_model}->{hdim}", encode_blocks, params, cfg, hidden)
    bench("  asr_res branch", asr_branch, params, cfg, hidden)
    x_mid = rand(B, T, hdim)
    asr_feat = rand(B, T, dd["asr_res"]["conv_w"].shape[0])
    bench("  5x AdainResBlk1d", adain_stack, params, cfg, x_mid, asr_feat, style)
    x_last = rand(B, T, dd["to_out"]["conv_w"].shape[1])
    bench("  out conv -> mel", out_conv, params, cfg, x_last)
    measure.report_launches("profile_mel", "bfloat16")
    print(json.dumps({**rows, "spread_ms": spread, "batch": B, "precision": "bfloat16"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
