#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (zerovox_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the MRF-stage kernel from csrc/ with nvcc, both modes at once
     (timed, ptxas report);
  3. hold the kernel against its plain PyTorch version (mrf_stage_ref) on
     the four production MRF stages (the options vocode gives them) and
     the mrf_stage_unfolded entry, TF32 off, in float32 and in bfloat16, at
     three shapes (B=1 full length, B=1 and B=8 at bucket 256) and at every
     window size of the streaming chunk plan (80, 96 and 44 mel frames: the
     first chunk, an interior one, the tail); time every launch with CUDA
     events next to the plain version and its bounds (f32: f32 FMA and
     3xTF32 tensor cores; bf16: dense bf16 tensor cores); print each
     launch's cluster geometry; time variants of the f32 geometry (longest
     tile, half and twice the weight chunk, rings of 2 and 4) against the
     plan, in turns;
  4. drive the main path at the production config (ZeroVoxConfig()
     defaults, random weights from seed 0), once in float32 and once in
     bfloat16: save a GGUF with the port's save_params, run the CLI on it,
     then a TTSEngine answering two B=1 requests and one bucket-packed
     batch of mixed lengths; check the waveforms and that every vocode
     went through the kernel (launch counts); time B=1 and B=8 synthesis;
     compare the kernel pipeline with the plain one (synthesize at B=1,
     synthesize_packed at B=8);
  5. streaming, in both dtypes: StreamingSynthesizer.stream on a
     full-length demo request (time to first chunk, whole stream with
     ahead=None and ahead=2, device time per window, every chunk through
     the kernel, stream == full run, ahead settings bit-identical) and the
     CLI's --stream;
  6. the engine's remainder, in both dtypes: synthesize_async + fetch
     against synthesize, single_rtt on and off timed, reload_params with
     other weights and with a wrong geometry;
  7. print the kernels line, then the card line, then {"ok": true, ...}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets) used for the roofline bounds:
# (f32 non-tensor FLOP/s, TF32 tensor-core FLOP/s, HBM bytes/s, bf16
# tensor-core FLOP/s).  Rates at the full power limit; the card's own limit
# is printed beside every number.
PEAKS = {"H100 PCIe": (51.2e12, 378e12, 2.0e12, 756e12),
         "H100": (66.9e12, 495e12, 3.35e12, 989e12)}
STAGE_TOL = 1e-4          # f32 kernel vs plain: atol STAGE_TOL * max|out|
# bf16 kernel vs plain, per element: 2 bf16 ulps of its magnitude (the sums
# differ in order, so a rounding of an operand or of the result can fall
# the other way) plus a floor of one ulp at the output's scale
BF16_STAGE_ULPS = 2.0
BF16_ULP = 2.0 ** -8
PIPELINE_WAV_ATOL = 2e-3        # f32 kernel pipeline vs plain pipeline
# bf16 waveforms of two paths whose sums differ in order (kernel vs plain
# pipeline; the vocoder at another bucket): 2 bf16 ulps at the top of [-1, 1]
WAV_ATOL_BF16 = 2.0 ** -7
STREAM_TOL = dict(atol=2e-5, rtol=1e-4)        # f32 stream vs full run
STREAM_ATOL_BF16 = 2.0 ** -8                   # bf16 stream vs full run: 1 ulp at the top
CHUNK_FRAMES, OVERLAP = 64, 16                 # the CLI's streaming defaults


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key in sorted(PEAKS, key=len, reverse=True):
        if key in name:
            return PEAKS[key]
    raise RuntimeError(f"no published peak rates for {name!r}")


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs (CUDA events), after one
    warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# --------------------------------------------------------------------------

def stage_work(x, C, L_out, K_up, n_convs, kr, weights_numel):
    """(FLOPs, bytes) one MRF stage call must do: every conv's MACs, the
    upsample's MACs, each input/weight read once and the output written
    once, in the tensors' own element size."""
    B, L_pre, Cin = x.shape
    flops = 2 * B * (n_convs * kr * C * C * L_out + (K_up * Cin * C * L_pre if K_up else 0))
    nbytes = x.element_size() * (x.numel() + B * L_out * C + weights_numel)
    return flops, nbytes


def bounds_of(x, got, blocks, kw, C, K_up, n_convs, kr, pk):
    """(FLOPs, bytes, {bound name: ms}) of one stage call on these inputs.
    float32: "fma" = max(FLOPs / f32 rate, bytes / HBM rate) and "tc" =
    max(3 FLOPs / TF32 rate, bytes / HBM rate), f32-accurate work done as
    three TF32 products per product.  bfloat16: "tc" = max(FLOPs / dense
    bf16 rate, bytes / HBM rate) with 2-byte activations and weights."""
    import torch
    f32, tf32, bw, bf16 = pk
    w_numel = sum(c[k].numel() for b in blocks for cs in ("convs1", "convs2")
                  for c in b[cs] for k in ("w", "b"))
    if kw:
        w_numel += kw["upsample"]["w"].numel() + kw["in_bias"].numel()
    flops, nbytes = stage_work(x, C, got.shape[1], K_up, n_convs, kr, w_numel)
    if x.dtype == torch.bfloat16:
        bounds = {"tc": 1e3 * max(flops / bf16, nbytes / bw)}
        by = "bytes" if nbytes / bw > flops / bf16 else "operations"
    else:
        bounds = {"fma": 1e3 * max(flops / f32, nbytes / bw),
                  "tc": 1e3 * max(3 * flops / tf32, nbytes / bw)}
        by = "bytes" if nbytes / bw > 3 * flops / tf32 else "operations"
    return flops, nbytes, bounds, by


def stage_calls(cfg, params, gen, B, L0):
    """(name, stage index, x, blocks, kwargs, C, K_up) for every vocoder stage
    as vocode calls it on a B x L0-frame mel, with random stage inputs whose
    batch rows differ, in the params' dtype."""
    import torch
    voc = params["vocoder"]
    L_pre, c_pre = L0, cfg.hifigan_channels
    calls = []
    for i, s in enumerate(cfg.upsample_scales):
        up = voc["upsamples"][i]
        blocks = [voc["blocks"][i * cfg.num_resblocks + j]
                  for j in range(cfg.num_resblocks)]
        C = up["w"].shape[0]
        x = torch.randn(B, L_pre, c_pre, generator=gen, device="cuda").to(up["w"].dtype)
        kw = dict(upsample=dict(w=up["w"], stride=s, padding=s // 2 + s % 2,
                                output_padding=s % 2),
                  in_bias=up["b"], in_leaky=0.1 if i == 0 else None,
                  out_leaky=0.01 if i == len(cfg.upsample_scales) - 1 else 0.1)
        calls.append(("mrf_stage", i, x, blocks, kw, C, up["w"].shape[2]))
        L_pre = L_pre * s
        c_pre = C
    return calls


def check_one(ms, name, i, x, blocks, kw, cfg, packed):
    """Kernel vs plain on one call; returns (kernel output, max|d|, the
    tolerance at the largest element).  float32: max|d| <= STAGE_TOL *
    max|ref|.  bfloat16: per element |d| <= BF16_STAGE_ULPS ulps of |ref|
    plus one ulp of max|ref|."""
    import torch
    fn = getattr(ms, name)
    dils, kr = cfg.resblock_dilations, cfg.resblock_kernel_size
    got = fn(x, blocks, dils, kr, packed=packed, **kw)
    ref = ms.mrf_stage_ref(x, blocks, dils, kr, **kw)
    torch.cuda.synchronize()
    what = f"{name} {str(x.dtype).split('.')[-1]} stage {i + 1} B={x.shape[0]} L={x.shape[1]}"
    if got.shape != ref.shape or got.dtype != x.dtype:
        raise RuntimeError(f"{what}: {got.dtype} {tuple(got.shape)} vs plain {tuple(ref.shape)}")
    d = (got.float() - ref.float()).abs()
    err = d.max().item()
    scale = ref.float().abs().max().item()
    if x.dtype == torch.bfloat16:
        tol = BF16_ULP * (BF16_STAGE_ULPS * ref.float().abs() + scale)
        worst = (d / tol).max().item()
        tol_at_max = BF16_ULP * (BF16_STAGE_ULPS + 1) * scale
        if not torch.isfinite(got.float()).all() or not worst <= 1.0:
            raise RuntimeError(f"{what}: |d| reaches {worst:.2f} of its tolerance "
                               f"({BF16_STAGE_ULPS} bf16 ulps + one at max|out| {scale:.3e})")
    else:
        tol_at_max = STAGE_TOL * scale
        if not torch.isfinite(got).all() or err > tol_at_max:
            raise RuntimeError(f"{what}: max|d| {err:.3e} > {STAGE_TOL} * max|out| "
                               f"({scale:.3e})")
    return got, err, tol_at_max


def launch_plan(ms, cfg, x, C, K_up, kw, L_out, **change):
    """The geometry mrf_stage launches this call with (`change`: another
    chunk or ring depth, for a variant)."""
    up = kw.get("upsample")
    return ms.stage_plan(x.device, C, cfg.resblock_dilations, cfg.resblock_kernel_size,
                         x.shape[0], L_out, x.shape[2] if up else 0, K_up,
                         up["stride"] if up else 1, x.dtype, **change)


def stream_windows(cfg):
    """Every distinct window size (mel frames) of the streaming chunk plan
    at the CLI's chunk and overlap.  The full-buffer plan has them all: a
    shorter request streams a prefix of it."""
    from zerovox_tpu_torch.models.streaming import chunk_plan
    plan = chunk_plan(cfg.max_seq_len, -(-cfg.max_seq_len // CHUNK_FRAMES), CHUNK_FRAMES,
                      OVERLAP)
    return list(dict.fromkeys(w[1] for w in plan))


def check_stages(cfg, params, gen, pk):
    """Kernel vs plain on the production stages, in the params' dtype;
    returns per-entry records for the kernels line (times and bounds of
    the B=1 full-length shape, the largest error of all shapes), the
    packed weights and the streaming window sizes that were held.

    B=1 at the full max_seq_len (the --no-trim / longest-bucket shape), B=1
    at bucket 256 (the serving shape of a 3 s utterance), B=8 at bucket 256
    (the engine's packed batch; every CTA's batch-row offset is checked),
    and every window size a stream gives the kernel (stream_windows: 80
    frames for the first chunk, 64 + 16 of overlap on one side; 96 for an
    interior chunk; 44 for the tail of a 1500-frame plan, 28 + 16), where a
    stage is less than one wave of clusters.  Each launch runs on weights
    packed beforehand, as the engine packs them."""
    import torch
    from zerovox_tpu_torch.models.hifigan import pack_vocoder
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms

    kr = cfg.resblock_kernel_size
    dils = cfg.resblock_dilations
    n_rb = len(dils)
    n_convs = sum(2 * len(d) for d in dils)
    packs = pack_vocoder(params, cfg)
    dtype = params["vocoder"]["upsamples"][0]["w"].dtype
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    records = {}
    windows = stream_windows(cfg)
    for shape, B, L0 in [("B=1 full", 1, cfg.max_seq_len), ("B=1 bucket 256", 1, 256),
                         ("B=8 bucket 256", 8, 256)] \
            + [(f"B=1 window {w}", 1, w) for w in windows]:
        stages = stage_calls(cfg, params, gen, B, L0)
        if shape == "B=1 full":
            # the unfolded entry (every option off) on stage 2's geometry
            _, _, x2, blocks2, _, C2, _ = stages[1]
            xu = torch.randn(1, x2.shape[1] * cfg.upsample_scales[1], C2, generator=gen,
                             device="cuda").to(dtype)
            stages.append(("mrf_stage_unfolded", 1, xu, blocks2, {}, C2, 0))
            unfolded_pack = ms.pack_stage(blocks2, dils, kr)
        tot = dict(ms=0.0, plain=0.0, fma=0.0, tc=0.0)
        for name, i, x, blocks, kw, C, K_up in stages:
            fn = getattr(ms, name)
            pkd = packs[i] if name == "mrf_stage" else unfolded_pack
            got, err, tol = check_one(ms, name, i, x, blocks, kw, cfg, pkd)
            plan = launch_plan(ms, cfg, x, C, K_up, kw, got.shape[1])
            ms_k = cuda_ms(lambda: fn(x, blocks, dils, kr, packed=pkd, **kw), reps=5)
            ms_p = cuda_ms(lambda: ms.mrf_stage_ref(x, blocks, dils, kr, **kw), reps=3)
            flops, nbytes, bounds, by = bounds_of(x, got, blocks, kw, C, K_up, n_convs, kr, pk)
            log(f"{tag} {shape} {name} stage {i + 1}: in {tuple(x.shape)} -> out "
                f"{tuple(got.shape)}  max|d| {err:.3e} (tol at max|out| {tol:.3e})  "
                f"kernel {ms_k:.3f} ms ({flops / ms_k / 1e9:.2f} TFLOP/s)  plain {ms_p:.3f} ms  "
                f"bound " + ", ".join(f"{k} {v:.3f} ms" for k, v in bounds.items())
                + f" ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
            log(f"    launch: {plan.clusters} clusters of ({n_rb},1,1) = "
                f"{plan.clusters * n_rb} CTAs x 256 threads, tile {plan.tile} rows "
                f"(window {plan.tile + 2 * ms.stage_halo(dils, kr)}), chunk {plan.kc} ch, "
                f"warp tile {plan.mt}x m16 by {plan.nt}x n8, {plan.smem} B shared; wave "
                f"{ms.wave_clusters(x.device.index or 0, n_rb, plan.nt, plan.mt, dtype)} "
                f"clusters")
            if name == "mrf_stage":
                tot["ms"] += ms_k
                tot["plain"] += ms_p
                for k, v in bounds.items():
                    tot[k] += v
            key = name + suffix
            if shape == "B=1 full":
                r = records.setdefault(key, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                                 max_abs_err=0.0, bound_by="operations"))
                r["ms"] += ms_k
                r["plain_ms"] += ms_p
                r["bound_ms"] += bounds["tc"]
                if by == "bytes":
                    r["bound_by"] = "bytes"
            if key in records:
                records[key]["max_abs_err"] = max(records[key]["max_abs_err"], err)
        log(f"{tag} {shape}, four mrf_stage launches: kernel {tot['ms']:.3f} ms, plain "
            f"{tot['plain']:.3f} ms, bound "
            + (f"f32-FMA {tot['fma']:.3f} ms ({100 * tot['fma'] / tot['ms']:.0f} %), 3xTF32 "
               if tot["fma"] else "bf16 tensor cores ")
            + f"{tot['tc']:.3f} ms ({100 * tot['tc'] / tot['ms']:.0f} %)")
    return records, packs, windows


def time_variants(cfg, params, gen, packs):
    """A/B of the geometry inside this call, on the B=1 full-length and
    bucket-256 stages: the plan mrf_stage uses, the longest tile (no wave
    fill), and plans with weight chunks of half and twice the input channels
    and rings of 2 and 4 chunks (each with its own longest tile and wave
    fill); each variant is checked against the plan's output and
    timed in turns (plan, variants, variants reversed, plan), median of 5."""
    import torch
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    kr, dils = cfg.resblock_kernel_size, cfg.resblock_dilations
    for shape, L0 in (("B=1 full", cfg.max_seq_len), ("B=1 bucket 256", 256)):
        for name, i, x, blocks, kw, C, K_up in stage_calls(cfg, params, gen, 1, L0):
            up = kw["upsample"]
            L_out = ms.transpose_out_len(x.shape[1], up["stride"], K_up, up["padding"],
                                         up["output_padding"])
            plan = launch_plan(ms, cfg, x, C, K_up, kw, L_out)
            variants = {"plan": plan,
                        "longest tile": ms.tile_plan(C, dils, kr, x.shape[2], K_up,
                                                     up["stride"])}
            for label, change in ((f"chunk {plan.kc // 2}", dict(kc=plan.kc // 2)),
                                  (f"chunk {plan.kc * 2}", dict(kc=plan.kc * 2)),
                                  ("ring 2", dict(stages=2)), ("ring 4", dict(stages=4))):
                try:
                    pl = launch_plan(ms, cfg, x, C, K_up, kw, L_out, **change)
                except ValueError:                  # no tile fits, or C % kc
                    continue
                if pl != plan:
                    variants[label] = pl
            def run(pl):
                return ms._launch(x, blocks, dils, kr, up, kw["in_bias"], kw["in_leaky"],
                                  kw["out_leaky"], packs[i], plan=pl)
            base = run(plan)
            for vname, pl in variants.items():
                err = (run(pl) - base).abs().max().item()
                if err > STAGE_TOL * base.abs().max().item():
                    raise RuntimeError(f"variant {vname} of stage {i + 1} disagrees: {err:.3e}")
            times = {k: [] for k in variants}
            for vname in list(variants) + list(variants)[::-1]:
                times[vname].append(cuda_ms(lambda: run(variants[vname]), reps=5))
            log(f"variants {shape} stage {i + 1}: " + ", ".join(
                f"{k} (tile {variants[k].tile}, chunk {variants[k].kc}, ring "
                f"{variants[k].stages}, warp {variants[k].mt}x{variants[k].nt}) "
                f"{' / '.join('%.3f' % t for t in v)} ms"
                for k, v in times.items()))
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

def mixed_batch(cfg, n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    P = cfg.max_n_phonemes
    lens = np.linspace(P, P // 8, n).astype(np.int32)   # n=1: full length
    src = np.zeros((n, P), np.int32)
    pun = np.zeros((n, P), np.int32)
    for i, L in enumerate(lens):
        src[i, :L] = rng.integers(1, cfg.num_phonemes + 1, size=L)
        pun[i, :L] = rng.integers(0, cfg.num_puncts + 1, size=L)
    style = rng.normal(scale=0.05, size=(n, cfg.d_model)).astype(np.float32)
    return src, pun, style, lens


def check_wavs(wavs, mel_len, hop, what):
    import numpy as np
    for w, m in zip(wavs, mel_len):
        w = np.asarray(w)
        if int(m) <= 0 or len(w) != int(m) * hop:
            raise RuntimeError(f"{what}: mel_len {int(m)} and {len(w)} samples")
        if not np.isfinite(w).all() or np.abs(w).max() > 1.0:
            raise RuntimeError(f"{what}: waveform not finite or outside [-1, 1]")


def main_path(cfg, params, model, tmp, precision):
    """CLI + engine requests at `precision` on the GGUF `model`; returns
    (launch counts, wall times, engine)."""
    import numpy as np
    import torch
    from zerovox_tpu_torch import cli
    from zerovox_tpu_torch.io.wav import read_wav
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    from zerovox_tpu_torch.runtime.engine import TTSEngine

    n_stages = len(cfg.upsample_scales)
    ms.mrf_stage.launches = ms.mrf_stage_unfolded.launches = 0
    wav_path = os.path.join(tmp, f"out_{precision}.wav")
    t0 = time.perf_counter()
    rc = cli.main(["--model", model, "--demo", "--output", wav_path, "--precision", precision])
    log(f"{precision} cli.main: rc {rc}, {time.perf_counter() - t0:.2f} s incl. load")
    wav, sr = read_wav(wav_path)
    if rc != 0 or sr != cfg.sampling_rate or len(wav) == 0 or not np.isfinite(wav).all():
        raise RuntimeError(f"cli produced rc={rc}, {len(wav)} samples at {sr} Hz")
    expected = n_stages                          # one B=1 vocode dispatch

    engine = TTSEngine(params, cfg, precision=precision)
    want = torch.bfloat16 if precision == "bfloat16" else torch.float32
    if engine.params["vocoder"]["upsamples"][0]["w"].dtype != want \
            or engine.vocoder_packed[0].w.dtype != want:
        raise RuntimeError(f"engine at {precision} holds {engine.vocoder_packed[0].w.dtype}")
    for seed in (1, 2):                          # two B=1 requests
        src, pun, style, lens = mixed_batch(cfg, 1, seed)
        wavs, mel_len = engine.synthesize(src, pun, style, lens)
        check_wavs(wavs, mel_len, cfg.hop_size, f"B=1 request {seed}")
        expected += n_stages
        log(f"{precision} B=1 request {seed}: mel_len {int(mel_len[0])}, "
            f"bucket {engine.pick_bucket(int(mel_len[0]))}")
    src, pun, style, lens = mixed_batch(cfg, 8, 3)
    wavs, mel_len = engine.synthesize_packed(src, pun, style, lens)
    check_wavs(wavs, mel_len, cfg.hop_size, "packed batch")
    groups = engine.group_by_bucket(mel_len)
    expected += n_stages * sum(len(list(engine._ladder_chunks(g)))
                               for g in groups.values())
    log(f"{precision} packed batch of 8: mel_len {mel_len.tolist()}, "
        f"groups {{{', '.join(f'{b}: {len(g)}' for b, g in groups.items())}}}")
    counts = {"mrf_stage": ms.mrf_stage.launches,
              "mrf_stage_unfolded": ms.mrf_stage_unfolded.launches}
    log(f"{precision} launches on the main path: {counts} (expected mrf_stage {expected})")
    if counts["mrf_stage"] != expected:
        raise RuntimeError(f"mrf_stage launched {counts['mrf_stage']} times, "
                           f"expected {expected}: a vocode missed the kernel")

    # wall time: B=1 and B=8 full requests (front + vocoder + host fetch),
    # then the same request split at the mel_len fetch into the front
    # (encoder, length regulator, decoder at max_seq_len) and the vocoder
    # at the request's bucket
    walls = {}
    for B in (1, 8):
        src, pun, style, lens = mixed_batch(cfg, B, 10 + B)
        src[:], pun[:] = src[0], pun[0]          # all full length
        lens[:] = lens[0]
        runs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.synthesize(src, pun, style, lens)
            runs.append(1e3 * (time.perf_counter() - t0))
        walls[B] = statistics.median(runs[1:])
        log(f"{precision} engine.synthesize B={B}: wall {walls[B]:.2f} ms "
            f"(median of {len(runs) - 1} after one warm-up; runs {['%.2f' % r for r in runs]})")
        fronts, backs = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mel, mel_len = engine._run_front(src, pun, style, lens)
            t1 = time.perf_counter()
            bucket = engine.pick_bucket(int(mel_len.max()))
            engine._back(mel[:, :bucket], False)
            fronts.append(1e3 * (t1 - t0))
            backs.append(1e3 * (time.perf_counter() - t1))
        log(f"  {precision} B={B} split: front {statistics.median(fronts):.2f} ms, vocoder at "
            f"bucket {bucket} {statistics.median(backs):.2f} ms (medians of 3; "
            f"fronts {['%.2f' % r for r in fronts]}, vocoders {['%.2f' % r for r in backs]})")
    return counts, walls, engine


@contextlib.contextmanager
def plain_vocoder():
    """Within the block, the vocoder runs every stage through the kernel's
    plain version (mrf_stage_ref), on the card."""
    from zerovox_tpu_torch.models import hifigan
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    kernel = hifigan.mrf_stage
    hifigan.mrf_stage = lambda *a, packed=None, **kw: ms.mrf_stage_ref(*a, **kw)
    try:
        yield
    finally:
        hifigan.mrf_stage = kernel


def compare_pipelines(engine):
    """The kernel path vs the plain path on the same inputs, in the
    engine's dtype: synthesize() at B=1, and the engine's packed batch of 8
    mixed lengths."""
    import numpy as np
    from zerovox_tpu_torch.models.pipeline import synthesize
    cfg, params = engine.cfg, engine.params
    atol = WAV_ATOL_BF16 if cfg.compute_dtype == "bfloat16" else PIPELINE_WAV_ATOL
    src, pun, style, lens = mixed_batch(cfg, 1, 5)
    got = synthesize(params, cfg, src, pun, style, lens)
    src8, pun8, style8, lens8 = mixed_batch(cfg, 8, 6)
    wavs, mel_len = engine.synthesize_packed(src8, pun8, style8, lens8)
    with plain_vocoder():
        ref = synthesize(params, cfg, src, pun, style, lens)
        ref_wavs, ref_mel_len = engine.synthesize_packed(src8, pun8, style8, lens8)
    if not np.array_equal(got.mel_len.cpu().numpy(), ref.mel_len.cpu().numpy()) \
            or not np.array_equal(mel_len, ref_mel_len):
        raise RuntimeError("kernel and plain pipelines disagree on mel_len")
    err = (got.wav.float() - ref.wav.float()).abs().max().item()
    err8 = max(float(np.abs(a - b).max()) for a, b in zip(wavs, ref_wavs))
    log(f"{cfg.compute_dtype} pipeline kernel vs plain: synthesize B=1 wav max|d| {err:.3e}, "
        f"mel_len {int(got.mel_len[0])}; synthesize_packed B=8 wav max|d| {err8:.3e}, "
        f"mel_len {mel_len.tolist()} (atol {atol})")
    if not max(err, err8) <= atol:
        raise RuntimeError(f"pipeline wav max|d| {max(err, err8):.3e} > {atol}")
    return max(err, err8)


# --------------------------------------------------------------------------
# phase 5: streaming
# --------------------------------------------------------------------------

def stream_path(cfg, params, model, tmp, engine, held_windows):
    """StreamingSynthesizer on a full-length demo request, in the engine's
    dtype; returns the mrf_stage launches of the streamed runs.  Every
    window size the request streams must be one of `held_windows`, those
    phase 3 held against the plain version."""
    import numpy as np
    import torch
    from zerovox_tpu_torch import cli
    from zerovox_tpu_torch.io.wav import read_wav
    from zerovox_tpu_torch.models.streaming import StreamingSynthesizer
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms

    precision = engine.cfg.compute_dtype
    scfg = engine.cfg
    n_stages = len(cfg.upsample_scales)
    synth = StreamingSynthesizer(params, scfg, chunk_frames=CHUNK_FRAMES, overlap=OVERLAP)
    ahead2 = StreamingSynthesizer(params, scfg, chunk_frames=CHUNK_FRAMES, overlap=OVERLAP,
                                  ahead=2)
    t0 = time.perf_counter()
    synth.warmup()
    log(f"{precision} stream warmup (prefix + every window geometry of the "
        f"{cfg.max_seq_len}-frame plan): {time.perf_counter() - t0:.2f} s")
    src, pun, style, lens = mixed_batch(cfg, 1, 21)

    def timed(s):
        """(chunks, ms to the first chunk, ms to the last) of one stream."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = s.stream(src, pun, style, lens)
        chunks = [next(it)]
        t1 = time.perf_counter()
        chunks.extend(it)
        return chunks, 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)

    timed(synth)                                   # one warm run of the request itself
    ms.mrf_stage.launches = ms.mrf_stage_unfolded.launches = 0
    runs = [timed(synth) for _ in range(3)]
    runs2 = [timed(ahead2) for _ in range(3)]
    launches = ms.mrf_stage.launches
    chunks = runs[0][0]
    n_chunks = len(chunks)
    streamed = [w[1] for w in synth.chunk_plan(cfg.max_seq_len, n_chunks)]
    if not set(streamed) <= set(held_windows):
        raise RuntimeError(f"{precision} stream: windows {streamed} were streamed, but only "
                           f"{held_windows} were held against the plain version")
    if launches != n_stages * n_chunks * 6:
        raise RuntimeError(f"{precision} stream: {launches} mrf_stage launches for 6 streams "
                           f"of {n_chunks} chunks, expected {n_stages * n_chunks * 6}")
    wav = np.concatenate(chunks, axis=1)
    for other, _, _ in runs[1:] + runs2:
        if not np.array_equal(np.concatenate(other, axis=1), wav):
            raise RuntimeError(f"{precision} stream: runs or ahead settings differ bitwise")
    ttfa = statistics.median(r[1] for r in runs)
    whole = statistics.median(r[2] for r in runs)
    whole2 = statistics.median(r[2] for r in runs2)
    log(f"{precision} stream, demo request: {n_chunks} chunks of {CHUNK_FRAMES} frames "
        f"(overlap {OVERLAP}; windows {streamed}), {launches} mrf_stage launches in 6 streams; time to first "
        f"chunk {ttfa:.2f} ms (median of 3: {['%.2f' % r[1] for r in runs]}); whole stream "
        f"ahead=None {whole:.2f} ms ({['%.2f' % r[2] for r in runs]}), ahead=2 "
        f"{whole2:.2f} ms ({['%.2f' % r[2] for r in runs2]}; first chunk "
        f"{['%.2f' % r[1] for r in runs2]}); per further chunk "
        f"{(whole - ttfa) / max(1, n_chunks - 1):.2f} ms on the host clock; ahead settings "
        f"bit-identical")

    # the stream against the one-shot run of the same request
    full, mel_len = engine.synthesize(src, pun, style, lens)
    n = int(mel_len[0]) * cfg.hop_size
    if wav.shape[1] < n or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        raise RuntimeError(f"{precision} stream: {wav.shape[1]} samples for mel_len {mel_len}")
    diff = float(np.abs(wav[0, :n] - full[0]).max())
    if precision == "bfloat16":
        ok, tol = diff <= STREAM_ATOL_BF16, f"atol {STREAM_ATOL_BF16}"
    else:
        ok = np.allclose(wav[0, :n], full[0], **STREAM_TOL)
        tol = f"atol {STREAM_TOL['atol']}, rtol {STREAM_TOL['rtol']}"
    log(f"{precision} stream vs engine.synthesize: max|d| {diff:.3e} over {n} samples ({tol})")
    if not ok:
        raise RuntimeError(f"{precision} stream differs from the full run: {diff:.3e} ({tol})")

    # device time of one window of each geometry, and of the prefix
    model_ = synth._model
    mel, _, _ = synth._prefix(model_, src, pun, style, lens)
    pre = cuda_ms(lambda: synth._prefix(model_, src, pun, style, lens), reps=3)
    seen = {}
    for w in synth.chunk_plan(cfg.max_seq_len, -(-cfg.max_seq_len // CHUNK_FRAMES)):
        if w[1:] not in seen:
            seen[w[1:]] = cuda_ms(lambda: synth._vocode_window(model_, mel, w), reps=5)
    log(f"{precision} stream device time (CUDA events): prefix {pre:.2f} ms; windows "
        + ", ".join(f"{size} frames (emit {e} from {f}) {t:.3f} ms"
                    for (size, f, e), t in seen.items()))

    out = os.path.join(tmp, f"stream_{precision}.wav")
    ms.mrf_stage.launches = 0
    rc = cli.main(["--model", model, "--demo", "--stream", "--precision", precision,
                   "--output", out])
    cli_launches = ms.mrf_stage.launches
    got, sr = read_wav(out)
    if rc != 0 or sr != cfg.sampling_rate or len(got) < n or not np.isfinite(got).all():
        raise RuntimeError(f"cli --stream produced rc={rc}, {len(got)} samples at {sr} Hz")
    if cli_launches * CHUNK_FRAMES * cfg.hop_size != n_stages * len(got):
        raise RuntimeError(f"cli --stream: {cli_launches} mrf_stage launches for "
                           f"{len(got)} samples")
    log(f"{precision} cli --stream: rc {rc}, {len(got)} samples at {sr} Hz, "
        f"{cli_launches} mrf_stage launches")
    return launches + cli_launches


# --------------------------------------------------------------------------
# phase 6: the engine's remainder
# --------------------------------------------------------------------------

def engine_remainder(cfg, engine):
    """synthesize_async + fetch, single_rtt on and off, reload_params."""
    import numpy as np
    import torch
    from zerovox_tpu_torch.params import init_params

    precision = engine.cfg.compute_dtype
    atol = WAV_ATOL_BF16 if precision == "bfloat16" else STREAM_TOL["atol"]
    src, pun, style, lens = mixed_batch(cfg, 3, 31)
    want, want_len = engine.synthesize(src, pun, style, lens)
    fetch = engine.synthesize_async(src, pun, style, lens)
    got, got_len = fetch()
    one, one_len = engine.synthesize(src, pun, style, lens, single_rtt=True)
    if not np.array_equal(got_len, want_len) or not np.array_equal(one_len, want_len):
        raise RuntimeError("synthesize_async and synthesize disagree on mel_len")
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    same = all(np.array_equal(a, b) for a, b in zip(got, one))
    log(f"{precision} synthesize_async + fetch vs synthesize (B=3, mixed lengths): wav "
        f"max|d| {err:.3e} (atol {atol}: the vocoder runs at another bucket); equal to "
        f"single_rtt=True bit for bit: {same}")
    if not err <= atol or not same:
        raise RuntimeError(f"synthesize_async differs: {err:.3e}, single_rtt equal {same}")

    src, pun, style, lens = mixed_batch(cfg, 1, 32)
    times = {}
    for rtt in (False, True, True, False):
        runs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.synthesize(src, pun, style, lens, single_rtt=rtt)
            runs.append(1e3 * (time.perf_counter() - t0))
        times.setdefault(rtt, []).append(statistics.median(runs[1:]))
    log(f"{precision} engine.synthesize B=1 wall, single_rtt off "
        f"{' / '.join('%.2f' % t for t in times[False])} ms, on "
        f"{' / '.join('%.2f' % t for t in times[True])} ms (in turns off, on, on, off; "
        f"medians of 3 after a warm-up)")

    before, _ = engine.synthesize(src, pun, style, lens)
    old = engine.params
    engine.reload_params(init_params(cfg, seed=1, device="cuda"))
    after, _ = engine.synthesize(src, pun, style, lens)
    check_wavs(after, [len(after[0]) // cfg.hop_size], cfg.hop_size, "after reload_params")
    if len(after[0]) == len(before[0]) and np.array_equal(after[0], before[0]):
        raise RuntimeError("reload_params with other weights left the output unchanged")
    bad = dict(old)
    bad["vocoder"] = dict(old["vocoder"])
    bad["vocoder"]["mean"] = old["vocoder"]["mean"][:-1]
    try:
        engine.reload_params(bad)
    except ValueError as e:
        log(f"{precision} reload_params: other weights change the output; a wrong geometry "
            f"raises ({str(e)[:80]}...)")
    else:
        raise RuntimeError("reload_params accepted a wrong geometry")
    engine.reload_params(old)
    again, _ = engine.synthesize(src, pun, style, lens)
    if not np.array_equal(again[0], before[0]):
        raise RuntimeError("reload_params back to the first weights does not restore the output")


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on the card only", file=sys.stderr)
        return 2
    if not (ROOT / "zerovox_tpu_torch" / "csrc" / "mrf_stage.cu").is_file():
        print(f"chip_smoke: no zerovox_tpu_torch package beside {__file__}; run "
              "it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.models.pipeline import cast_params
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    from zerovox_tpu_torch.params import init_params, save_params

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    pk = peaks(name)
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"bounds from {pk[0] / 1e12:.1f} TFLOP/s f32, {pk[1] / 1e12:.0f} TFLOP/s TF32, "
        f"{pk[3] / 1e12:.0f} TFLOP/s bf16, {pk[2] / 1e12:.2f} TB/s")

    t0 = time.perf_counter()
    lib = ms.library()
    log(f"built {ms.SOURCE.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds:.1f} s)")
    for line in lib.build_log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "rror")):
            log(f"  ptxas: {line.strip()}")

    cfg = ZeroVoxConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    params16 = cast_params(params, torch.bfloat16)
    log(f"production params (seed 0) on the card in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    records, packs, held = check_stages(cfg, params, gen, pk)
    records16, _, _ = check_stages(cfg, params16, gen, pk)
    records.update(records16)
    time_variants(cfg, params, gen, packs)

    launches = {}
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "model.gguf")
        t0 = time.perf_counter()
        save_params(model, params, cfg)
        log(f"wrote {model} ({os.path.getsize(model) / 1e6:.1f} MB, "
            f"{time.perf_counter() - t0:.1f} s)")
        for precision, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            counts, walls[precision], engine = main_path(cfg, params, model, tmp, precision)
            compare_pipelines(engine)
            streamed = stream_path(cfg, params, model, tmp, engine, held)
            engine_remainder(cfg, engine)
            launches["mrf_stage" + suffix] = counts["mrf_stage"] + streamed
            launches["mrf_stage_unfolded" + suffix] = counts["mrf_stage_unfolded"]
            log(f"{precision} launches: main path {counts}, streams {streamed}")

    replaces = {"mrf_stage": "zerovox_tpu/ops/pallas/folded_mrf.py:446",
                "mrf_stage_unfolded": "zerovox_tpu/ops/pallas/folded_mrf.py:720"}
    kernels = [{
        "name": k, "route": "cuda", "source": "zerovox_tpu_torch/csrc/mrf_stage.cu",
        "replaces": replaces[k.replace("_bf16", "")], "launches": launches[k],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
    } for k, r in records.items()]
    log("kernels line: ms, plain_ms and bound_ms are the sums over the four B=1 "
        "full-length stages (the unfolded entry: its one call); bound_ms is the "
        "tensor-core bound of the mode: f32 max(3 FLOPs / TF32 rate, bytes / HBM rate), "
        "bf16 max(FLOPs / bf16 rate, bytes / HBM rate); launches are those of the mode's "
        "main path (CLI, engine requests) plus its streams, each counted from 0")
    log("e2e: " + "; ".join(f"{p} B=1 wall {w[1]:.2f} ms, B=8 wall {w[8]:.2f} ms"
                            for p, w in walls.items())
        + f"; smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
