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
     every shape a serving process launches: each batch size of the
     engine's ladder (1, 2, 4, 8) at each mel bucket (256, 512, 1024, 1500)
     and every window size of the streaming chunk plan (80, 96 and 44 mel
     frames: the first chunk, an interior one, the tail), and in float32
     phase 9's windows (phase9_shapes: the time-sharded TP windows of 786
     frames at B = 1, 2, 4, 8 and of 411 at B = 4, the time-parallel
     vocoder's 76 and 92 at B = 1); at three of them
     (B=1 full length, B=1 and B=8 at bucket 256) and at the windows, time
     every launch with CUDA events next to the plain version and its bounds (f32: f32 FMA and
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
  7. the serving daemon, in bfloat16 (the serving dtype) and float32: an
     in-process TTSServer on a loopback port and a TTSClient: /healthz and
     /metrics (the device row names the card), /synthesize as JSON and as a
     binary body against engine.synthesize, /batch against
     synthesize_packed, /stream against /synthesize, ?split=1 on a
     300-phoneme utterance on both endpoints, bad requests (400, 413, 404,
     503 with max_concurrent=1); sequential latency of /synthesize (JSON,
     binary) beside the engine called directly; 8 closed-loop client
     threads against a daemon with the batcher off and one with
     batch_window_ms=5 (every answer held against the direct one;
     requests/s, p50, p95, mean batch size), /stream's time to first byte
     alone and beside 7 other streams; /reload to other weights, to another
     geometry (409) and under a stream in flight; what another batch size
     does to an answer (the variance adaptor's buckets tapped at B=1 and at
     the ladder's sizes); once, a subprocess
     `python -m zerovox_tpu_torch.cli --serve` answered by the module
     client and drained by SIGTERM.  Phases 4-9 fail if they launch the
     kernel at a shape that phase 3 did not hold;
  8. training, in float32 (zerovox_tpu_torch.training): (a) vocode through
     the kernel with weights that require a gradient raises, and
     vocode(differentiable=True) gives every vocoder weight a gradient
     without a kernel launch; (b) three AdamW steps at TINY on the card
     against the same on the CPU; (c) one production-geometry loss and its
     gradients (B=1, max_seq_len, the STFT loss) on the card and on the
     CPU, per leaf, each against the same loss in float64; step time (host
     clock and CUDA events) and peak memory at B = 1, 2, 4, 8, where (f)
     the loss of 10 B=1 steps on one batch must fall; (d) `python -m zerovox_tpu_torch.training.cli` at
     production geometry (24 datums, batch 8, --accum 2, 2 steps and 1
     validation batch), then again, resuming; the checkpoints' sizes; (e)
     a TTSEngine on its exported GGUF, kernel pipeline against the plain one,
     launched shapes held;
  9. multi-device serving (zerovox_tpu_torch.parallel), on meshes of the
     one card repeated (and of distinct cards where the machine has them),
     at production width: make_sharded_synthesize on (4, 1), (2, 2) and
     (1, 4) in float32 (pure DP also in bfloat16) and the channel-sharded
     TP fallback on (2, 2); TTSEngine(mesh=(4, 1)) over its whole scaled
     ladder; TPServingEngine on (2, 2) with a reload; PipelinedTTS with
     front = back = cuda:0 over 8 utterances; TimeParallelVocoder over 4; a
     TTSServer on (2, 1) with two concurrent /stream sessions on the
     rotation and one on (1, 2); each held against the single-device run
     on the card, its weights packed once (TP: atol 2e-4 / rtol 1e-3, and
     where float order moved a pitch or energy bucket or a frame count,
     each move within FLIP_DELTA and the answer at the same gate against
     the one-device back end continuing the TP front; DP, pipeline,
     time-parallel: the stream gate; bf16 DP: 2^-7; the daemons in LSB),
     with its kernel launches, wall (median of 3) and card time and its
     cost over the single-device run (on one card a regime cannot be
     faster: its cost is its extra work); FLIP_DELTA's readings: the
     largest f32 TP prediction gap, and the gap with TF32 products;
     then a TINY checkpoint served on the card, every stage on the plain
     route (its widths are not the kernel's);
 10. training on a mesh (zerovox_tpu_torch.training.make_sharded_train_step,
     parallel.distributed), production geometry, random weights from seed
     0: (a) the sharded step on (2, 1), (1, 2) and (2, 2) of the card
     repeated (on a machine with four cards: (4, 1) and (2, 2) of distinct
     cards), 4 rows with the STFT loss, each against the one-device step on
     the same rows: in float64 the loss (rtol 1e-5) and an SGD step's
     gradient per leaf (tests/test_torch_training.py's rule); in float32
     the loss within 1e-3 of float64 (and the one device's rows one at a
     time beside it), two AdamW steps (2 * lr per step), the gradient's
     distances printed, with wall (median of 3), busy time (torch.profiler)
     and peak memory beside the one-device step's; (b) the training CLI as
     two processes (gloo on one card; two processes of two cards each over
     nccl on four), launched and resumed, both ranks printing the same
     final loss (on four cards also the port's two-process worker), and
     the export served by a one-card engine, its launched shapes held; (c)
     --compile-cache: two fresh processes share a directory, the second
     builds nothing (the kernel's nvcc, the native library); (d) the native
     GGUF loader against the numpy one: load_params and /reload times
     (median of 3), the parameters bitwise equal;
 11. print the kernels line, then the card line, then {"ok": true, ...}.

With --multi-device-only it runs phases 1-3, 9 and 10 and prints no result
line: the quick way to drive the distinct-card regimes on a machine with
several cards.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
# the daemon's PCM16 answers against the engine's, in LSB of int16.  float32:
# the same code on the same weights and shapes, 1 LSB (a batched request
# runs at another batch size and bucket: a last-ulp float difference can
# cross a quantisation boundary).  bfloat16: the waveform gates above at
# int16 scale (another bucket or batch size: 2^-7; the stream: 2^-8).
PCM_LSB = {"float32": 1, "bfloat16": WAV_ATOL_BF16 * 32767}
PCM_LSB_STREAM = {"float32": 1, "bfloat16": STREAM_ATOL_BF16 * 32767}
# the engine's batch ladder and mel buckets (its defaults; the last bucket is
# max_seq_len): every (batch size, bucket) a serving process can vocode at
LADDER, BUCKETS = (1, 2, 4, 8), (256, 512, 1024, 1500)
LOAD_CLIENTS, LOAD_ROUNDS = 8, 10              # closed-loop client threads x requests each
LATENCY_REQUESTS = 30
# `python3 chip_smoke.py --multi-device-only`: phases 1-3, then phase 9 alone
# (on a machine with several cards, its distinct-card regimes), and no
# result line
MULTI_DEVICE_ONLY = "--multi-device-only"


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


def p95(xs):
    """The 95th percentile of xs (nearest rank)."""
    xs = sorted(xs)
    return xs[max(0, -(-95 * len(xs) // 100) - 1)]


def in_threads(fn, n, timeout=600):
    """fn(i) on n threads started together; their results in order.  A
    failure, or a thread still alive at the timeout, raises here."""
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def worker(i):
        try:
            barrier.wait(timeout=timeout)
            results[i] = fn(i)
        except Exception as e:          # noqa: BLE001  (reported below)
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"client threads failed or hung: {errors[:3]}")
    return results


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs (CUDA events), after one
    warm-up call."""
    from zerovox_tpu_torch.utils.profiling import device_time
    return device_time(fn, iters=1, reps=reps, cuda=True)


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


def check_stages(cfg, params, gen, pk, extra=()):
    """Kernel vs plain on the production stages, in the params' dtype;
    returns per-entry records for the kernels line (times and bounds of
    the B=1 full-length shape, the largest error of all shapes), the
    packed weights, the streaming window sizes that were held, and the set
    of (dtype, input shape) of every mrf_stage call that was held.

    Timed: B=1 at the full max_seq_len (the --no-trim / longest-bucket shape), B=1
    at bucket 256 (the serving shape of a 3 s utterance), B=8 at bucket 256
    (the engine's packed batch; every CTA's batch-row offset is checked),
    and every window size a stream gives the kernel (stream_windows: 80
    frames for the first chunk, 64 + 16 of overlap on one side; 96 for an
    interior chunk; 44 for the tail of a 1500-frame plan, 28 + 16), where a
    stage is less than one wave of clusters.  Held and not timed: every
    other batch size of LADDER at every bucket of BUCKETS (what the
    batcher, /batch, ?split=1 and the warm-ups vocode at: tile_plan depends
    on B, L and the wave, so each is another launch geometry), and every
    (B, mel frames) of `extra` (phase 9's windows).  Each launch runs on
    weights packed beforehand, as the engine packs them."""
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
    held = set()
    windows = stream_windows(cfg)
    if BUCKETS[-1] != cfg.max_seq_len:
        raise RuntimeError(f"the last bucket is {BUCKETS[-1]}, max_seq_len {cfg.max_seq_len}")
    timed = [("B=1 full", 1, cfg.max_seq_len), ("B=1 bucket 256", 1, 256),
             ("B=8 bucket 256", 8, 256)] + [(f"B=1 window {w}", 1, w) for w in windows]
    for B, L0 in [(B, L0) for B in LADDER for L0 in BUCKETS] + list(extra):
        if (B, L0) in {t[1:] for t in timed}:
            continue
        worst, clusters = [], []
        for name, i, x, blocks, kw, C, K_up in stage_calls(cfg, params, gen, B, L0):
            got, err, tol = check_one(ms, name, i, x, blocks, kw, cfg, packs[i])
            held.add((x.dtype, tuple(x.shape)))
            worst.append(err / tol)
            clusters.append(launch_plan(ms, cfg, x, C, K_up, kw, got.shape[1]))
            records[name + suffix] = dict(max_abs_err=max(
                err, records.get(name + suffix, {}).get("max_abs_err", 0.0)))
            del got
        log(f"{tag} B={B} at {L0} mel frames held against the plain version, stages 1-4: max|d| at "
            + ", ".join(f"{w:.2f}" for w in worst) + " of the tolerance at max|out|; "
            + ", ".join(f"{p.clusters} clusters of tile {p.tile}" for p in clusters))
    torch.cuda.empty_cache()
    for shape, B, L0 in timed:
        stages = stage_calls(cfg, params, gen, B, L0)
        held.update((x.dtype, tuple(x.shape)) for _, _, x, *_ in stages)
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
                r = records.setdefault(key, {})
                for k, v in dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                                 bound_by="operations").items():
                    r.setdefault(k, v)
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
    return records, packs, windows, held


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
    if engine.batch_ladder != LADDER or engine.mel_buckets != BUCKETS:
        raise RuntimeError(f"the engine's ladder {engine.batch_ladder} and buckets "
                           f"{engine.mel_buckets} are not those phase 3 held")
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


def record_launch_shapes():
    """From here on, every vocoder call of mrf_stage in this process is
    noted by (dtype, input shape) before it goes on to the kernel's
    wrapper; returns the dict of counts."""
    from zerovox_tpu_torch.models import hifigan
    wrapper = hifigan.mrf_stage
    seen, lock = {}, threading.Lock()

    def recording(x, *a, **kw):
        key = (x.dtype, tuple(x.shape))
        with lock:
            seen[key] = seen.get(key, 0) + 1
        return wrapper(x, *a, **kw)

    hifigan.mrf_stage = recording
    return seen


def hold_launched_shapes(seen, held, what):
    """Fail if the main path launched mrf_stage at a shape that phase 3 did
    not hold against the plain version."""
    missing = sorted((str(k[0]), k[1]) for k in seen if k not in held)
    by_batch = {}
    for (_, shape), n in seen.items():
        by_batch[shape[0]] = by_batch.get(shape[0], 0) + n
    log(f"{what}: mrf_stage was launched at {len(seen)} distinct (dtype, shape) so far, by batch "
        f"size {dict(sorted(by_batch.items()))}; all held against the plain version in phase 3: "
        f"{not missing}")
    if missing:
        raise RuntimeError(f"{what}: mrf_stage ran at shapes phase 3 did not hold: {missing[:8]}")


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



# --------------------------------------------------------------------------
# phase 7: the serving daemon
# --------------------------------------------------------------------------

def lsb_diff(a, b, what):
    """max |a - b| of two PCM16 arrays of one length, in LSB."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.size == 0 or a.dtype != np.int16 or b.dtype != np.int16:
        raise RuntimeError(f"{what}: {a.dtype} {a.shape} against {b.dtype} {b.shape}")
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def hold(a, b, gate, what):
    d = lsb_diff(a, b, what)
    if d > gate:
        raise RuntimeError(f"{what}: PCM16 differs by {d} LSB (gate {gate})")
    return d


def raw_post(address, path, body=b"{}", claim_length=None):
    """(status, headers, body) of a POST; claim_length sends that
    Content-Length and no body (a server that refuses by the header alone
    answers without reading it)."""
    c = http.client.HTTPConnection(*address, timeout=60)
    try:
        c.putrequest("POST", path)
        c.putheader("Content-Type", "application/json")
        c.putheader("Content-Length", str(len(body) if claim_length is None else claim_length))
        c.endheaders()
        if claim_length is None:
            c.send(body)
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def expect_error(fn, error_type, status, what):
    try:
        fn()
    except error_type as e:
        if e.status != status:
            raise RuntimeError(f"{what}: HTTP {e.status}, expected {status}") from e
        return str(e)
    raise RuntimeError(f"{what}: no error, expected HTTP {status}")


def daemon_endpoints(cfg, engine, server, client, precision):
    """Every endpoint of a running daemon against the engine on the same
    weights; returns the demo request and its direct answer."""
    import numpy as np
    import torch
    from zerovox_tpu_torch.cli import _demo_utterance
    from zerovox_tpu_torch.runtime.client import TTSServerError, utterance
    from zerovox_tpu_torch.runtime.longform import split_utterance, synthesize_long

    gate, gate_stream = PCM_LSB[precision], PCM_LSB_STREAM[precision]
    hop = cfg.hop_size
    h = client.health()
    m = client.metrics()
    row = m["device"]["devices"][0]
    if h["status"] != "ok" or h["precision"] != precision or h["max_seq_len"] != cfg.max_seq_len \
            or row["kind"] != torch.cuda.get_device_name(0) or row["platform"] != "gpu" \
            or not row["bytes_in_use"] > 0 or not row["bytes_limit"] > row["bytes_in_use"]:
        raise RuntimeError(f"/healthz {h} or /metrics device row {row} is wrong")
    log(f"{precision} daemon /healthz {h}; /metrics device {m['device']}")

    src, pun, style, n = _demo_utterance(cfg)
    ph, st, pu = src[0], style[0], pun[0]
    want, want_len = engine.synthesize(src, pun, style, n, pcm16=True)
    check_wavs([want[0] / 32767.0], want_len, hop, "engine.synthesize pcm16")
    as_json, rate = client.synthesize(ph, st, pu)
    as_binary, _ = client.synthesize(ph, st, pu, binary=True)
    untrimmed, _ = client.synthesize(ph, st, pu, trim=False)
    if rate != cfg.sampling_rate or not np.array_equal(as_json, as_binary) \
            or len(untrimmed) != cfg.max_seq_len * hop:
        raise RuntimeError("/synthesize: JSON and binary bodies differ, or a wrong rate or length")
    d_direct = hold(as_json, want[0], gate, "/synthesize against engine.synthesize")
    d_trim = hold(untrimmed[:len(as_json)], as_json, gate, "/synthesize?trim=0 against trim=1")

    src8, pun8, style8, lens8 = mixed_batch(cfg, 8, 3)
    wavs8, mel8 = engine.synthesize_packed(src8, pun8, style8, lens8, pcm16=True)
    got8, got_mel8, _ = client.batch([utterance(src8[i, :lens8[i]], style8[i], pun8[i, :lens8[i]])
                                      for i in range(8)])
    if list(got_mel8) != [int(x) for x in mel8]:
        raise RuntimeError(f"/batch mel_len {got_mel8} against synthesize_packed {mel8.tolist()}")
    d_batch = max(hold(a, b, gate, f"/batch row {i}") for i, (a, b) in enumerate(zip(got8, wavs8)))

    streamed = np.concatenate(list(client.stream(ph, st, pu)))
    streamed_b = np.concatenate(list(client.stream(ph, st, pu, binary=True)))
    n_chunks = -(-int(want_len[0]) // CHUNK_FRAMES)
    if len(streamed) != n_chunks * CHUNK_FRAMES * hop or not np.array_equal(streamed, streamed_b):
        raise RuntimeError(f"/stream: {len(streamed)} samples for mel_len {int(want_len[0])}")
    d_stream = hold(streamed[:len(as_json)], as_json, gate_stream, "/stream against /synthesize")

    rng = np.random.default_rng(41)
    long_ph = rng.integers(1, cfg.num_phonemes + 1, size=300)
    long_pu = (rng.random(300) < 0.1).astype(np.int32)
    long_wav, long_mel = synthesize_long(engine, long_ph, long_pu, st, pcm16=True)
    got_long, _ = client.synthesize(long_ph, st, long_pu, split=True)
    d_long = hold(got_long, long_wav, gate, "/synthesize?split=1 against synthesize_long")
    long_stream = np.concatenate(list(client.stream(long_ph, st, long_pu, split=True)))
    expect = sum(max(1, -(-int(x) // CHUNK_FRAMES)) for x in long_mel) * CHUNK_FRAMES * hop
    if len(long_mel) < 3 or len(long_stream) != expect:
        raise RuntimeError(f"/stream?split=1: {len(long_stream)} samples for windows "
                           f"{long_mel.tolist()}, expected {expect}")
    # the split stream is its windows' own streams, one after the other, bit for bit
    srcs, puns, lens = split_utterance(long_ph, long_pu, cfg.max_n_phonemes)
    one_by_one = np.concatenate([c for i in range(len(lens))
                                 for c in client.stream(srcs[i, :lens[i]], st, puns[i, :lens[i]])])
    if not np.array_equal(long_stream, one_by_one):
        raise RuntimeError("/stream?split=1 differs from its windows streamed one by one")
    # each window's audio (then the rest of its last chunk) is held against the engine's answer
    # to that window alone, at the stream's gate.  Against /synthesize?split=1 it is gated in
    # float32 only: that ran the windows as one packed batch, at another batch size than a
    # stream's B=1 windows, which in bfloat16 can move a bucket of the variance adaptor and
    # with it the audio (batch_size_effect shows it), so there it is reported
    at, at_s, d_long_stream, d_long_direct = 0, 0, 0, 0
    for i, x in enumerate(long_mel):
        k = int(x) * hop
        d_long_stream = max(d_long_stream, lsb_diff(long_stream[at_s:at_s + k],
                                                    got_long[at:at + k], "/stream?split=1 window"))
        alone, alone_len = engine.synthesize(srcs[i:i + 1], puns[i:i + 1], st[None],
                                             lens[i:i + 1], pcm16=True)
        if int(alone_len[0]) != int(x) and precision == "float32":
            raise RuntimeError(f"window {i}: mel_len {int(x)} in the batch, {alone_len} alone")
        d_long_direct = max(d_long_direct, hold(
            long_stream[at_s:at_s + int(alone_len[0]) * hop], alone[0], gate_stream,
            f"/stream?split=1 window {i} against engine.synthesize of that window"))
        at += k
        at_s += max(1, -(-int(x) // CHUNK_FRAMES)) * CHUNK_FRAMES * hop
    if precision == "float32" and d_long_stream > gate:
        raise RuntimeError(f"/stream?split=1 against /synthesize?split=1: {d_long_stream} LSB")

    expect_error(lambda: client.synthesize([1, 2, 3], [0.0]), TTSServerError, 400, "bad style")
    expect_error(lambda: client.synthesize(np.ones(cfg.max_n_phonemes + 1, np.int32), st),
                 TTSServerError, 400, "too many phonemes")
    for path, kw, status in (("/synthesize", dict(body=b"{]"), 400),
                             ("/synthesize", dict(claim_length=server.max_body_bytes + 1), 413),
                             ("/nope", {}, 404)):
        got, _, body = raw_post(server.address, path, **kw)
        if got != status or "error" not in json.loads(body):
            raise RuntimeError(f"POST {path} {list(kw)}: HTTP {got}, expected {status}")
    log(f"{precision} daemon endpoints, PCM16 LSB: /synthesize vs engine {d_direct}, trim=0 vs "
        f"trim=1 {d_trim} (gate {gate}); JSON == binary bit for bit; /batch of 8 mixed vs "
        f"synthesize_packed {d_batch}; /stream vs /synthesize {d_stream} (gate {gate_stream:g}), "
        f"{n_chunks} chunks; ?split=1 of 300 phonemes: {len(long_mel)} windows "
        f"{long_mel.tolist()}, /synthesize vs synthesize_long {d_long}, /stream == its windows "
        f"streamed one by one, per window vs engine.synthesize of it {d_long_direct} (gate "
        f"{gate_stream:g}), vs /synthesize?split=1 (a packed batch) per window "
        f"{d_long_stream}{' (reported, not gated)' if precision != 'float32' else ''}; 400, 413, "
        f"404 answered")
    return (ph, st, pu), as_json


def daemon_admission(cfg, params, precision, request):
    """max_concurrent=1: a second request while the first is inside the
    engine gets 503 + Retry-After and no body; the slot frees afterwards."""
    from zerovox_tpu_torch.runtime.client import TTSClient, TTSServerError
    from zerovox_tpu_torch.runtime.server import TTSServer
    ph, st, pu = request
    s = TTSServer(params, cfg, port=0, precision=precision, warmup=False, max_concurrent=1)
    gate, entered = threading.Event(), threading.Event()
    inner = s.engine.synthesize

    def slow(*a, **kw):
        entered.set()
        gate.wait(timeout=60)
        return inner(*a, **kw)

    s.engine.synthesize = slow
    s.start()
    try:
        no_retry = TTSClient(*s.address, timeout=120, retries_503=0)
        first = {}
        t = threading.Thread(target=lambda: first.update(wav=no_retry.synthesize(ph, st, pu)[0]),
                             daemon=True)
        t.start()
        if not entered.wait(timeout=60):
            raise RuntimeError("the first request never reached the engine")
        expect_error(lambda: no_retry.synthesize(ph, st, pu), TTSServerError, 503,
                     "second request at max_concurrent=1")
        status, headers, body = raw_post(s.address, "/stream", json.dumps({}).encode())
        if (status, headers.get("Retry-After"), body) != (503, "1", b""):
            raise RuntimeError(f"/stream at max_concurrent=1: {status} {headers} {body[:80]}")
        gate.set()
        t.join(timeout=120)
        if t.is_alive() or len(first.get("wav", ())) == 0:
            raise RuntimeError("the first request did not finish after the gate opened")
        again, _ = TTSClient(*s.address, timeout=120).synthesize(ph, st, pu)
        if lsb_diff(again, first["wav"], "after the slot freed") != 0:
            raise RuntimeError("the request after the shed one differs from the first")
        errors = s.metrics.snapshot()["endpoints"]["/synthesize"]["errors"]
    finally:
        gate.set()
        s.shutdown()
    log(f"{precision} daemon max_concurrent=1: 503 + Retry-After on /synthesize and /stream while "
        f"one request is in flight, 200 after it; {errors} shed /synthesize in /metrics")


def daemon_latency(engine, client, precision, request, want):
    """Sequential /synthesize requests, JSON and binary, beside the engine
    called directly in this process: what HTTP, JSON and WAV cost."""
    import numpy as np
    ph, st, pu = request
    P = len(ph)
    src, pun, style, n = ph[None], pu[None], st[None], np.asarray([P], np.int32)
    runs = {"json": [], "binary": [], "direct": []}
    calls = {"json": lambda: client.synthesize(ph, st, pu)[0],
             "binary": lambda: client.synthesize(ph, st, pu, binary=True)[0],
             "direct": lambda: engine.synthesize(src, pun, style, n, pcm16=True)[0][0]}
    for _ in range(LATENCY_REQUESTS):                      # in turns, so they share the host's mood
        for name, call in calls.items():
            t0 = time.perf_counter()
            got = call()
            runs[name].append(1e3 * (time.perf_counter() - t0))
            # the daemon repeats itself bit for bit; the other engine is held at the gate
            hold(got, want, PCM_LSB[precision] if name == "direct" else 0,
                 f"a sequential {name} request against the first answer")
    log(f"{precision} daemon latency, {LATENCY_REQUESTS} sequential requests each, in turns "
        f"(host clock, ms): " + "; ".join(
            f"{name} p50 {statistics.median(r):.2f} p95 {p95(r):.2f} min {min(r):.2f}"
            for name, r in runs.items())
        + f"; HTTP + JSON + WAV cost at p50 "
          f"{statistics.median(runs['json']) - statistics.median(runs['direct']):.2f} ms")
    return {k: statistics.median(v) for k, v in runs.items()}


def ladder_answers(engine, request):
    """The engine's PCM16 answer to `request` at every ladder size, as a
    batched dispatch gives it (synthesize_async: the largest bucket; a batch
    of k equal requests padded to ladder size L is L equal rows).  Each is
    held against the plain pipeline (every stage through mrf_stage_ref) at
    the same batch size and bucket, at the pipeline gate of the dtype."""
    import numpy as np
    ph, st, pu = request
    precision = engine.cfg.compute_dtype
    gate = 32767 * (WAV_ATOL_BF16 if precision == "bfloat16" else PIPELINE_WAV_ATOL)
    n = np.asarray([len(ph)], np.int32)

    def answers():
        return {L: engine.synthesize_async(np.repeat(ph[None], L, 0), np.repeat(pu[None], L, 0),
                                           np.repeat(st[None], L, 0), np.repeat(n, L),
                                           pcm16=True)()[0][0]
                for L in engine.batch_ladder}

    got = answers()
    with plain_vocoder():
        plain = answers()
    worst = {L: hold(got[L], plain[L], gate, f"the batched answer at B={L}, bucket "
                     f"{engine.mel_buckets[-1]}, against the plain pipeline at that shape")
             for L in got}
    log(f"{precision} engine.synthesize_async at B={list(got)}, bucket {engine.mel_buckets[-1]}: "
        f"kernel pipeline vs plain pipeline at the same shape, PCM16 LSB {worst} (gate {gate:g})")
    return got


def daemon_load(server, precision, request, want, label, batched=None):
    """LOAD_CLIENTS closed-loop client threads, LOAD_ROUNDS requests each.
    Past the batcher every answer is held against the direct one (`want`:
    B=1, its own bucket).  Through the batcher a request runs at another
    batch size and at the largest bucket; the daemon says at which size
    (X-Batch-Size), and the answer is held to 1 LSB against the engine's own
    at that size (`batched`: ladder_answers, each held against the plain
    pipeline).  In float32 it is also held against the direct answer; in
    bfloat16 its distance to the direct one is reported (another batch size
    can move a bucket of the variance adaptor: batch_size_effect)."""
    from zerovox_tpu_torch.runtime.client import parse_wav_bytes, utterance
    ph, st, pu = request
    gate = PCM_LSB[precision]
    body = json.dumps(utterance(ph, st, pu)).encode()
    sizes, sizes_lock = {}, threading.Lock()

    def loop(i):
        lat, worst, worst_direct = [], 0, 0
        for _ in range(LOAD_ROUNDS):
            t0 = time.perf_counter()
            status, headers, raw = raw_post(server.address, "/synthesize?trim=1", body)
            if status != 200:
                raise RuntimeError(f"{label}: HTTP {status} under load")
            got, _ = parse_wav_bytes(raw)
            lat.append(1e3 * (time.perf_counter() - t0))
            worst_direct = max(worst_direct, lsb_diff(got, want, label))
            if batched is None:
                worst = worst_direct
            else:
                size = int(headers["X-Batch-Size"])
                with sizes_lock:
                    sizes[size] = sizes.get(size, 0) + 1
                worst = max(worst, lsb_diff(got, batched[size],
                                            f"{label}: an answer computed at B={size}"))
        return lat, worst, worst_direct

    before = server.batcher.snapshot() if server.batcher is not None else None
    t0 = time.perf_counter()
    out = in_threads(loop, LOAD_CLIENTS)
    wall = time.perf_counter() - t0
    lat = [x for l, _, _ in out for x in l]
    worst, worst_direct = max(o[1] for o in out), max(o[2] for o in out)
    line = (f"{precision} daemon load, {label}: {LOAD_CLIENTS} clients x {LOAD_ROUNDS} requests in "
            f"{wall:.3f} s = {len(lat) / wall:.1f} requests/s; per request p50 "
            f"{statistics.median(lat):.2f} ms, p95 {p95(lat):.2f} ms; worst PCM16 difference to "
            f"the direct answer {worst_direct} LSB"
            + (f" (gate {gate:g})" if batched is None or precision == "float32" else " (reported)")
            + (f", to the engine's answer at the batch size the daemon named {worst} LSB (gate 1; "
               f"answers by X-Batch-Size {dict(sorted(sizes.items()))})" if batched else ""))
    if before is not None:
        snap = server.batcher.snapshot()
        reqs = snap["requests"] - before["requests"]
        disp = snap["dispatches"] - before["dispatches"]
        line += (f"; batcher: {disp} dispatches, mean batch size {reqs / max(1, disp):.2f}, "
                 f"max_batch {snap['max_batch']}")
    log(line)
    if worst > (1 if batched else gate):
        raise RuntimeError(f"{label}: an answer under load is {worst} LSB from the engine's")
    if precision == "float32" and worst_direct > gate:
        raise RuntimeError(f"{label}: an answer under load is {worst_direct} LSB from the "
                           "direct one")
    if before is not None and (reqs != len(lat) or snap["max_batch"] <= 1):
        raise RuntimeError(f"batcher under load: {snap} after {len(lat)} requests: nothing "
                           "was coalesced")
    return len(lat) / wall


def batch_size_effect(cfg, engine):
    """What another batch size does to an answer, in the engine's dtype.

    Nine utterances (the demo request, eight of mixed lengths) go through
    the engine alone and as the first of 2, 4 and 8 equal rows, each at its
    own bucket.  The front's taps (utils.debug.capture_run) give the
    variance adaptor's pitch and energy predictions and the log-durations;
    their bucket indices and frame counts at B > 1 are compared with B=1,
    phoneme by phoneme, and printed where they differ.  Where none differs,
    the audio is held against the B=1 answer at the dtype's gate (float32:
    1 LSB; bfloat16: 2^-7 of full scale).  Where one does, the utterance is
    another input to the decoder from there on, and its distance is
    reported."""
    import numpy as np
    from zerovox_tpu_torch.cli import _demo_utterance
    from zerovox_tpu_torch.ops.length_regulator import durations_from_log
    from zerovox_tpu_torch.ops.misc import bucketize
    from zerovox_tpu_torch.utils.debug import capture_run
    precision = engine.cfg.compute_dtype
    gate = PCM_LSB[precision]
    src8, pun8, style8, lens8 = mixed_batch(cfg, 8, 3)
    demo = _demo_utterance(cfg)
    utts = [tuple(np.asarray(a) for a in demo[:3]) + (np.atleast_1d(demo[3]),)] \
        + [(src8[i:i + 1], pun8[i:i + 1], style8[i:i + 1], lens8[i:i + 1]) for i in range(8)]

    def run(utt, L):
        rows = [np.repeat(a, L, axis=0) for a in utt]
        n = int(utt[3][0])
        _, taps = capture_run(engine._issue_front, *engine._inputs(*rows), engine.model)
        idx = {k: bucketize(taps[k], cfg.ve_n_bins)[0, :n].cpu().numpy()
               for k in ("pitch", "energy")}
        idx["frames"] = durations_from_log(taps["log_duration"],
                                           cfg.max_seq_len)[0, :n].cpu().numpy()
        wavs, mel_len = engine.synthesize(*rows, pcm16=True)
        return idx, wavs[0], int(mel_len[0])

    same, moved, failed = [], [], []
    for u, utt in enumerate(utts):
        base_idx, base_wav, base_len = run(utt, 1)
        for L in LADDER[1:]:
            idx, wav, mel_len = run(utt, L)
            flips = [f"{k} of phoneme {p}: {base_idx[k][p]} -> {idx[k][p]}"
                     for k in idx for p in np.flatnonzero(idx[k] != base_idx[k])]
            d = lsb_diff(wav, base_wav, "batch_size_effect") if mel_len == base_len else None
            if flips:
                moved.append(d)
                log(f"  {precision} utterance {u} ({int(utt[3][0])} phonemes) at B={L}: "
                    f"{len(flips)} bucket or frame count(s) differ from B=1 ({'; '.join(flips[:4])}"
                    f"{' ...' if len(flips) > 4 else ''}); mel_len {base_len} -> {mel_len}; audio "
                    + (f"{d} LSB from B=1" if d is not None else "of another length"))
            else:
                same.append(d)
                if d is None or d > gate:
                    failed.append((u, L, d))
    known = [d for d in moved if d is not None]
    log(f"{precision} batch size against B=1, {len(utts)} utterances x B={list(LADDER[1:])}: "
        f"{len(same)} runs with every pitch and energy bucket and frame count as at B=1: audio "
        f"within {max(same, default=None)} LSB (gate {gate:g}); {len(moved)} runs where one "
        f"differs: audio {min(known, default=None)} to {max(known, default=None)} LSB from B=1, "
        f"{len(moved) - len(known)} of another length (reported)")
    if failed:
        raise RuntimeError(f"{precision}: with every bucket as at B=1 the audio still differs "
                           f"beyond the gate (utterance, B, LSB): {failed}")
    if not same and precision == "float32":
        raise RuntimeError("float32: a bucket moved with the batch size in every run")


def daemon_ttfb(server, precision, request):
    """/stream's time to the first audio bytes at the client, alone and
    beside LOAD_CLIENTS - 1 other streams started together."""
    import numpy as np
    from zerovox_tpu_torch.runtime.client import TTSClient
    ph, st, pu = request
    client = TTSClient(*server.address, timeout=120)

    def one(_=0):
        t0 = time.perf_counter()
        it = client.stream(ph, st, pu)
        first = next(it)
        t1 = time.perf_counter()
        rest = [first] + list(it)
        return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0), np.concatenate(rest)

    alone = [one() for _ in range(6)][1:]
    rounds = [in_threads(one, LOAD_CLIENTS) for _ in range(3)]
    ref = alone[0][2]
    for r in rounds:
        for _, _, wav in r:
            if not np.array_equal(wav, ref):
                raise RuntimeError("a stream beside others differs from the stream alone")
    together = [x[0] for r in rounds for x in r]
    log(f"{precision} daemon /stream time to first byte (host clock at the client, ms): alone "
        f"median {statistics.median(a[0] for a in alone):.2f} of 5 "
        f"({' '.join('%.2f' % a[0] for a in alone)}), whole stream "
        f"{statistics.median(a[1] for a in alone):.2f}; beside {LOAD_CLIENTS - 1} other streams, "
        f"3 rounds of {LOAD_CLIENTS}: median {statistics.median(together):.2f}, min "
        f"{min(together):.2f}, max {max(together):.2f}, whole stream median "
        f"{statistics.median(x[1] for r in rounds for x in r):.2f}; every stream bit-equal to "
        f"the stream alone")


def daemon_reload(cfg, server, client, precision, request, model, other_model, tiny_model):
    """/reload to other weights, to another geometry, and under a stream."""
    import numpy as np
    from zerovox_tpu_torch.params import load_params
    from zerovox_tpu_torch.runtime.client import TTSServerError
    from zerovox_tpu_torch.runtime.engine import TTSEngine
    ph, st, pu = request
    P = len(ph)
    gate = PCM_LSB[precision]
    before, _ = client.synthesize(ph, st, pu)
    t0 = time.perf_counter()
    answer = client.reload(other_model)
    t_reload = time.perf_counter() - t0
    after, _ = client.synthesize(ph, st, pu)
    if answer.get("status") != "reloaded" or server.stream._model is not server.engine.model \
            or (len(after) == len(before) and np.array_equal(after, before)):
        raise RuntimeError(f"/reload {answer}: the output did not change, or the synthesizer "
                           "holds weights of its own")
    _, loaded = load_params(other_model)
    fresh = TTSEngine(loaded, cfg, precision=precision)
    want, _ = fresh.synthesize(ph[None], pu[None], st[None], np.asarray([P], np.int32), pcm16=True)
    d_fresh = hold(after, want[0], gate, "after /reload against a fresh engine")
    streamed = np.concatenate(list(client.stream(ph, st, pu)))
    d_stream = hold(streamed[:len(after)], after, PCM_LSB_STREAM[precision],
                    "/stream after /reload against /synthesize")
    msg = expect_error(lambda: client.reload(tiny_model), TTSServerError, 409, "another geometry")
    still, _ = client.synthesize(ph, st, pu)
    if not np.array_equal(still, after):
        raise RuntimeError("a refused /reload changed the daemon's output")
    # a stream in flight while the weights are swapped back
    it = client.stream(ph, st, pu)
    chunks = [next(it)]
    client.reload(model)
    chunks.extend(it)
    mid = np.concatenate(chunks)
    # it read its weights once, at its start: it ends as the stream before it did
    if not np.array_equal(mid, streamed):
        raise RuntimeError(f"a stream across /reload ended with {len(mid)} samples that are "
                           f"not the {len(streamed)} of the stream before it")
    back, _ = client.synthesize(ph, st, pu)
    if np.array_equal(back, after):
        raise RuntimeError("/reload back to the first checkpoint left the output unchanged")
    log(f"{precision} daemon /reload: {t_reload:.2f} s; the output changes and is a fresh "
        f"engine's on the new checkpoint to {d_fresh} LSB (gate {gate:g}), /stream follows "
        f"({d_stream} LSB); another geometry: 409 ({msg[:60]}...), output unchanged; a stream in "
        f"flight across a reload ends bit-equal to the stream before it ({len(mid)} samples)")


def daemon_subprocess(model, tmp, cfg, precision):
    """python -m zerovox_tpu_torch.cli --serve in a process of its own, one
    request of the module client, then SIGTERM: exit code 0, no traceback."""
    from zerovox_tpu_torch.cli import _demo_utterance
    from zerovox_tpu_torch.io.wav import read_wav
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    src, pun, style, _ = _demo_utterance(cfg)
    utt = os.path.join(tmp, "utt.json")
    with open(utt, "w") as f:
        json.dump({"phonemes": src[0].tolist(), "puncts": pun[0].tolist(),
                   "style": style[0].tolist()}, f)
    out = os.path.join(tmp, "served.wav")
    err_path = os.path.join(tmp, "serve.err")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "zerovox_tpu_torch.cli", "--model", model, "--serve",
             "--port", str(port), "--precision", precision, "--batch-window-ms", "5"],
            stderr=err, stdout=subprocess.DEVNULL, cwd=str(ROOT), env=env)
        try:
            deadline = time.time() + 240
            up = False
            while time.time() < deadline and proc.poll() is None and not up:
                time.sleep(0.25)
                with open(err_path) as f:
                    up = "serving on http://" in f.read()
            if not up:
                with open(err_path) as f:
                    raise RuntimeError(f"cli --serve never came up (rc {proc.poll()}): "
                                       f"{f.read()[-2000:]}")
            t_up = time.perf_counter() - t0
            one = subprocess.run(
                [sys.executable, "-m", "zerovox_tpu_torch.runtime.client", "--port", str(port),
                 "--json", utt, "--out", out],
                capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env)
            if one.returncode != 0:
                raise RuntimeError(f"module client failed: {one.stderr[-1000:]}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    with open(err_path) as f:
        said = f.read()
    wav, rate = read_wav(out)
    if rc != 0 or "Traceback" in said or rate != cfg.sampling_rate or len(wav) == 0:
        raise RuntimeError(f"cli --serve: rc {rc}, {len(wav)} samples at {rate} Hz; stderr: "
                           f"{said[-2000:]}")
    log(f"{precision} cli --serve in a subprocess: serving after {t_up:.1f} s (CUDA start, load, "
        f"warm-up); module client: {one.stdout.strip().splitlines()[-1]}; SIGTERM -> exit code "
        f"{rc}, no traceback")


def daemon_path(cfg, params, engine, models, tmp, precision, subprocess_too):
    """Phase 7 at `precision`; returns the phase's mrf_stage launches in
    this process: the daemons' (their warm-ups included: they go through
    the kernel too) and those of the engines their answers are held
    against."""
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    from zerovox_tpu_torch.runtime.client import TTSClient
    from zerovox_tpu_torch.runtime.server import TTSServer
    model, other_model, tiny_model = models
    ms.mrf_stage.launches = ms.mrf_stage_unfolded.launches = 0
    kw = dict(port=0, precision=precision, chunk_frames=CHUNK_FRAMES, overlap=OVERLAP)
    t0 = time.perf_counter()
    server = TTSServer(params, cfg, allow_reload=True, batch_window_ms=0, **kw)
    log(f"{precision} TTSServer up in {time.perf_counter() - t0:.2f} s (engine warm-up at the "
        f"ladder top over buckets {server.engine.mel_buckets}, stream warm-up); the synthesizer "
        f"reads the engine's weights: {server.stream._model is server.engine.model}")
    if server.stream._model is not server.engine.model:
        raise RuntimeError("the daemon's synthesizer holds weights of its own")
    server.start()
    try:
        client = TTSClient(*server.address, timeout=120)
        request, want = daemon_endpoints(cfg, engine, server, client, precision)
        daemon_admission(cfg, params, precision, request)
        daemon_latency(engine, client, precision, request, want)
        off = daemon_load(server, precision, request, want, "batcher off")
        batching = TTSServer(params, cfg, batch_window_ms=5, **kw)
        batching.start()
        try:
            batched = ladder_answers(engine, request)
            on = daemon_load(batching, precision, request, want, "batch_window_ms=5", batched)
            lone, _ = TTSClient(*batching.address, timeout=120).synthesize(*request)
            hold(lone, batched[1], 0, "a lone request through the batcher against "
                                      "engine.synthesize_async at B=1")
            hold(lone, want, PCM_LSB[precision], "a lone request through the batcher")
            lat = []
            for _ in range(10):
                time.sleep(0.02)                  # let the dispatcher go idle
                t1 = time.perf_counter()
                TTSClient(*batching.address, timeout=120).synthesize(*request)
                lat.append(1e3 * (time.perf_counter() - t1))
            log(f"{precision} daemon, a lone request through the batcher (vocodes at bucket "
                f"{batching.engine.mel_buckets[-1]}): p50 {statistics.median(lat):.2f} ms of 10; "
                f"load: batching / off = {on / off:.2f}")
        finally:
            batching.shutdown()
        daemon_ttfb(server, precision, request)
        daemon_reload(cfg, server, client, precision, request, model, other_model, tiny_model)
        batch_size_effect(cfg, engine)
        snap = client.metrics()
        log(f"{precision} daemon /metrics at the end: " + ", ".join(
            f"{k} {v['count']} requests ({v['errors']} errors) p50 {v['p50_ms']} ms"
            for k, v in sorted(snap["endpoints"].items()))
            + f"; device bytes_in_use {snap['device']['devices'][0]['bytes_in_use'] / 1e6:.0f} MB")
    finally:
        server.shutdown()
    launches = ms.mrf_stage.launches
    if launches == 0 or ms.mrf_stage_unfolded.launches:
        raise RuntimeError(f"daemon phase: {launches} mrf_stage launches")
    if subprocess_too:
        daemon_subprocess(model, tmp, cfg, precision)
    log(f"{precision} daemon phase: {launches} mrf_stage launches in this process (the daemons "
        f"and the engines their answers are held against)")
    return launches


# --------------------------------------------------------------------------
# phase 8: training on the card (f32)
# --------------------------------------------------------------------------

def named_leaves(tree, cfg):
    """[(GGUF name, tensor)] of a parameter-shaped tree, in the name map's order."""
    from zerovox_tpu_torch.params import get_path, gguf_name_map
    return [(name, get_path(tree, path)) for path, (name, _) in gguf_name_map(cfg).items()]


def grad_distances(g, g64, cfg):
    """{GGUF name: (max|g - g64|, max|g64|)} per leaf."""
    return {n: ((a.detach().cpu().double() - c.detach().cpu()).abs().max().item(),
                c.abs().max().item())
            for (n, a), (_, c) in zip(named_leaves(g, cfg), named_leaves(g64, cfg))}


def hold_grads(grads, g64, cfg, what):
    """grads: {label: float32 gradient tree}, the card's under "card".  Logs
    each one's per-leaf distance to the float64 gradient, max|d| /
    max|g64_leaf| (worst and median over the leaves above 1e-6 max|g64|),
    and card against CPU.  Gate: every card leaf within 0.1 * max|g64_leaf|
    + 1e-6 * max|g64| (a wrong or missing term of the gradient is off by its
    whole size), and the card's median within 5 x the CPU's."""
    import numpy as np
    dist = {k: grad_distances(g, g64, cfg) for k, g in grads.items()}
    dist["card-CPU"] = {n: (d, dist["card"][n][1]) for n, (d, _) in
                        grad_distances(grads["card"], grads["CPU"], cfg).items()}
    gmax = max(m for _, m in dist["card"].values())
    medians = {}
    for label, rows in dist.items():
        ratios = sorted((d / m, n) for n, (d, m) in rows.items() if m > 1e-6 * gmax)
        medians[label] = float(np.median([r for r, _ in ratios]))
        log(f"  {what}, {label}{'' if label == 'card-CPU' else '-f64'}: max|d| / max|g64_leaf| "
            f"worst {ratios[-1][0]:.3e} ({ratios[-1][1]}), median {medians[label]:.3e} over "
            f"{len(ratios)} leaves")
    bad = [f"{n}: max|d| {d:.3e}, max|g64| {m:.3e}" for n, (d, m) in dist["card"].items()
           if not d <= 0.1 * m + 1e-6 * gmax]
    log(f"  {what}: gate per card leaf 0.1 * max|g64_leaf| + 1e-6 * max|g64| ({gmax:.3e}), "
        f"card median <= 5 x CPU median")
    if bad or not medians["card"] <= 5 * medians["CPU"]:
        raise RuntimeError(f"{what}: {len(bad)} leaves outside the gate {bad[:4]}; medians "
                           f"{medians}")


def timed_steps(step, state, batch, n):
    """n train steps on the card; per step the host-clock wall (synchronised)
    and the CUDA-event time, ms, and the losses' totals."""
    import torch
    walls, events, totals = [], [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, losses = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        events.append(start.elapsed_time(end))
        totals.append(losses["total"].item())
    return state, walls, events, totals


def training_path(cfg, params, tmp, card, seen, held):
    """Phase 8: the repair, TINY and production steps card against CPU, the
    training CLI twice (a resume) at production geometry, the engine on its
    export, the loss falling, step times and peak memory per batch size.
    Returns the mrf_stage launches of the engine served from the export."""
    import torch
    from zerovox_tpu_torch.config import TINY_CONFIG
    from zerovox_tpu_torch.models import hifigan
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    from zerovox_tpu_torch.params import init_params, load_params, tree_leaves, tree_map
    from zerovox_tpu_torch.runtime.engine import TTSEngine
    from zerovox_tpu_torch.training import make_train_step
    from zerovox_tpu_torch.training.cli import synthetic_dataset
    from zerovox_tpu_torch.training.losses import stft_loss
    from zerovox_tpu_torch.training.train import TrainBatch, batch_to, value_and_grad

    t_phase = time.perf_counter()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    launches0 = ms.mrf_stage.launches + ms.mrf_stage_unfolded.launches

    # (a) the kernel refuses autograd; the differentiable route gives every
    # vocoder leaf a gradient, and launches no kernel
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    mel = torch.randn(1, cfg.max_seq_len, cfg.num_mels, device=cuda)
    try:
        hifigan.vocode(live, cfg, mel)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        log(f"  (a) vocode on the card with grad-requiring weights raises: {str(e)[:90]}...")
    else:
        raise RuntimeError("(a) vocode through the kernel with grad-requiring weights did not raise")
    mel = torch.randn(1, BUCKETS[0], cfg.num_mels, device=cuda)
    wav = hifigan.vocode(live, cfg, mel, differentiable=True)
    loss = stft_loss(wav, 0.1 * torch.randn_like(wav))
    voc = tree_leaves(live["vocoder"])
    grads = torch.autograd.grad(loss, voc)
    zero = sum(int(not g.abs().max().item() > 0) for g in grads)
    if zero or ms.mrf_stage.launches + ms.mrf_stage_unfolded.launches != launches0:
        raise RuntimeError(f"(a) differentiable route: {zero} of {len(voc)} vocoder leaves with "
                           f"no gradient, launches {launches0} -> {ms.mrf_stage.launches}")
    log(f"  (a) vocode(differentiable=True) at {BUCKETS[0]} frames: STFT loss "
        f"{loss.item():.6f}, a non-zero gradient on all {len(voc)} vocoder leaves, no kernel launch")
    del live, wav, loss, grads

    # (b) TINY: three AdamW steps on the card against the same three on the CPU
    res = ((256, 30, 120), (128, 15, 60))
    p_tiny = init_params(TINY_CONFIG, seed=0, device="cpu")
    data = synthetic_dataset(TINY_CONFIG, 4, seed=0)
    lr = 1e-4
    runs = []
    for dev in (cuda, cpu):
        state, step = make_train_step(TINY_CONFIG, p_tiny, device=dev, stft_resolutions=res)
        totals = []
        for _ in range(3):
            state, losses = step(state, data)
            totals.append(losses["total"].item())
        runs.append((state, totals))
    (s_card, l_card), (s_cpu, l_cpu) = runs
    dp = max((a.cpu() - b).abs().max().item() for a, b in
             zip(tree_leaves(s_card.params), tree_leaves(s_cpu.params)))
    dl = abs(l_card[0] - l_cpu[0]) / abs(l_cpu[0])
    log(f"  (b) TINY, 3 AdamW steps (lr {lr}), card vs CPU: params max|d| {dp:.3e} (gate "
        f"2 * lr * 3 = {6 * lr:.1e}: Adam moves a near-zero gradient's weight by about lr "
        f"whatever its float noise); first loss {l_card[0]:.7f} vs {l_cpu[0]:.7f} (rel "
        f"{dl:.2e}, gate 1e-5); losses card {['%.6f' % v for v in l_card]}")
    if not (dp <= 6 * lr and dl <= 1e-5 and s_card.step == 3):
        raise RuntimeError(f"(b) TINY steps: params max|d| {dp:.3e}, first loss rel {dl:.2e}")

    # (c) production geometry, B=1, full max_seq_len, the STFT loss: one
    # loss_fn value and its gradients on the card and on the CPU, each held
    # against the same loss computed in float64 (the plain path, on the card)
    batch = synthetic_dataset(cfg, 1, seed=0)
    wide = lambda t: t.double() if t.is_floating_point() else t     # noqa: E731
    t0 = time.perf_counter()
    l_card, g_card = value_and_grad(params, cfg, batch_to(batch, cuda))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    l64, g64 = value_and_grad(tree_map(wide, params), cfg,
                              TrainBatch(*map(wide, batch_to(batch, cuda))))
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    p_cpu = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    l_cpu, g_cpu = value_and_grad(p_cpu, cfg, batch_to(batch, cpu))
    cpu_s = time.perf_counter() - t0
    rel = {n: max(abs(l[k].item() - l64[k].item()) / abs(l64[k].item()) for k in l64)
           for n, l in (("card", l_card), ("CPU", l_cpu))}
    log(f"  (c) production loss_fn B=1 with the STFT: card {l_card['total'].item():.7f}, CPU "
        f"{l_cpu['total'].item():.7f}, float64 {l64['total'].item():.7f} (worst term rel to "
        f"float64: card {rel['card']:.2e}, CPU {rel['CPU']:.2e}, gate 1e-5); loss + gradients "
        f"card f32 {card_s:.2f} s (first call), card f64 {f64_s:.2f} s, CPU f32 {cpu_s:.1f} s "
        f"({os.cpu_count()} cores) [{card}]")
    if not max(rel.values()) <= 1e-5:
        raise RuntimeError(f"(c) production loss against float64: {rel}")
    # the same on the card with PyTorch's own convolutions in place of cuDNN's
    torch.backends.cudnn.enabled = False
    try:
        _, g_native = value_and_grad(params, cfg, batch_to(batch, cuda))
    finally:
        torch.backends.cudnn.enabled = True
    hold_grads({"card": g_card, "CPU": g_cpu, "card without cuDNN": g_native}, g64, cfg,
               "(c) production gradients")
    del g_card, g_cpu, g_native, g64, p_cpu

    # (f) and the times: one repeated production batch per batch size; B=1
    # takes 10 steps and its loss must fall
    for B in (1, 2, 4, 8):
        state, step = make_train_step(cfg, params, device=cuda)
        batch = batch_to(synthetic_dataset(cfg, B, seed=B), cuda)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, walls, events, totals = timed_steps(step, state, batch, 10 if B == 1 else 3)
        peak = torch.cuda.max_memory_allocated()
        log(f"  step B={B} (AdamW, STFT, f32, TF32 off): wall {statistics.median(walls[1:]):.1f} ms, "
            f"CUDA events {statistics.median(events[1:]):.1f} ms (medians after the first; walls "
            f"{['%.1f' % w for w in walls]}); peak memory {peak / 2**30:.2f} GiB "
            f"(max_memory_allocated; {base / 2**30:.2f} GiB held before the step) [{card}]")
        if B == 1:
            log(f"  (f) loss over 10 steps on one batch: {['%.5f' % v for v in totals]}")
            if not totals[-1] < totals[0]:
                raise RuntimeError(f"(f) the loss did not fall: {totals[0]} -> {totals[-1]}")
        del state, step, batch

    # (d) the training CLI in a subprocess at production geometry, twice;
    # the blocks this process's allocator caches go back to the card first
    torch.cuda.empty_cache()
    ck, out = os.path.join(tmp, "train_ck"), os.path.join(tmp, "trained.gguf")
    argv = [sys.executable, "-m", "zerovox_tpu_torch.training.cli", "--synthetic", "24",
            "--batch-size", "8", "--val-split", "0.33", "--accum", "2", "--epochs", "1",
            "--checkpoint-dir", ck, "--checkpoint-every", "2", "--export", out]
    for i, want in ((1, 2), (2, 4)):
        t0 = time.perf_counter()
        run = subprocess.run(argv, capture_output=True, text=True, timeout=600, cwd=ROOT)
        wall = time.perf_counter() - t0
        lines = [ln for ln in run.stderr.splitlines() if ln.startswith(("train:", "fit:"))]
        for ln in lines:
            log(f"    cli run {i}: {ln}")
        if run.returncode != 0 or f"train: {want} total steps" not in run.stderr \
                or (i == 2) != ("resumed from step 2" in run.stderr):
            raise RuntimeError(f"(d) training CLI run {i}: rc {run.returncode}\n{run.stderr[-3000:]}")
        log(f"  (d) training CLI run {i}: rc 0, {want} steps, {wall:.1f} s in the subprocess "
            f"(import, card, init, 2 steps of 8 rows in 2 microbatches, 1 validation batch, "
            f"checkpoints, export) [{card}]")
    sizes = {n: os.path.getsize(os.path.join(ck, n)) for n in sorted(os.listdir(ck))}
    log(f"  (d) checkpoints {', '.join(f'{n} {s / 1e6:.1f} MB' for n, s in sizes.items())}; "
        f"export {os.path.getsize(out) / 1e6:.1f} MB")
    if sorted(sizes) != ["step_2.pt", "step_4.pt"]:
        raise RuntimeError(f"(d) checkpoint directory holds {sorted(sizes)}")

    # (e) the export, served through the kernel and held against the plain pipeline
    ms.mrf_stage.launches = ms.mrf_stage_unfolded.launches = 0
    tcfg, tparams_ = load_params(out, device="cuda")
    if tcfg != cfg:
        raise RuntimeError("(e) the exported GGUF has another geometry")
    engine = TTSEngine(tparams_, tcfg)
    compare_pipelines(engine)
    served = ms.mrf_stage.launches
    if not served or ms.mrf_stage_unfolded.launches:
        raise RuntimeError(f"(e) the engine on the export launched mrf_stage {served} times")
    hold_launched_shapes(seen, held, "phase 8")
    log(f"  (e) the exported GGUF served by a TTSEngine: {served} mrf_stage launches, kernel "
        f"pipeline within {PIPELINE_WAV_ATOL} of the plain one")
    log(f"phase 8 (training) {time.perf_counter() - t_phase:.1f} s [{card}]")
    return served


# --------------------------------------------------------------------------
# phase 9: multi-device serving
# --------------------------------------------------------------------------

TPV_CHUNK, TPV_OVERLAP = 60, 16                # TimeParallelVocoder's defaults
TP_TOL = dict(atol=2e-4, rtol=1e-3)            # f32 TP against one device (the JAX tests' gate)


def phase9_shapes(cfg):
    """Every (per-device batch, mel frames) phase 9 vocodes through the
    kernel beyond LADDER x BUCKETS: the time-sharded TP windows at model 2
    (every ladder size: the TP engine and daemon) and model 4 (B=4: a
    (1, 4) mesh over a batch of 4), and the time-parallel vocoder's windows
    at B=1."""
    from zerovox_tpu_torch.models.streaming import chunk_plan
    from zerovox_tpu_torch.parallel.infer import time_shard_geometry
    w2, w4 = time_shard_geometry(cfg, 2)[2], time_shard_geometry(cfg, 4)[2]
    tpv = {w[1] for w in chunk_plan(cfg.max_seq_len, -(-cfg.max_seq_len // TPV_CHUNK),
                                    TPV_CHUNK, TPV_OVERLAP)}
    return sorted({(b, w2) for b in LADDER} | {(4, w4)} | {(1, w) for w in tpv})


def timed_run(fn):
    """(fn(), host-clock ms, ms between CUDA events on the card's stream)
    from a synchronised start to a synchronised end."""
    import torch
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), start.elapsed_time(end)


def busy_ms(fn) -> float:
    """The card's busy time of one fn() call: the device time of every
    kernel and copy torch.profiler saw (launches from every thread)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
            else "self_cuda_time_total")
    busy = sum(getattr(e, attr) for e in averages if e.device_type == DeviceType.CUDA) / 1e3
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    return busy


TIMED_RUNS = 3          # timed runs of each phase 9 regime and of its one-device run


def regime(name, run, single, hold_fn, kernel=True):
    """Drive `run` once to warm it (cuDNN's plans on the issuing thread),
    then TIMED_RUNS times, the first with the launch count set to 0 and
    read just after, each timed on the host clock and between CUDA events;
    then the single-device `single` the same way; then each once under
    torch.profiler for the card's busy time.  hold_fn(got, want) checks the
    first runs' answers and describes.  Reports medians beside every
    reading; returns the regime's mrf_stage launches."""
    import torch
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms

    def one_device():
        with torch.inference_mode():          # as the serving paths run
            return single()

    def timed(fn):
        runs = [timed_run(fn) for _ in range(TIMED_RUNS)]
        return (runs[0][0], statistics.median(r[1] for r in runs),
                statistics.median(r[2] for r in runs), [r[1] for r in runs])
    run()
    one_device()
    ms.mrf_stage.launches = ms.mrf_stage_unfolded.launches = 0
    got, _, _ = timed_run(run)
    launches, unfolded = ms.mrf_stage.launches, ms.mrf_stage_unfolded.launches
    _, wall, span, walls = timed(run)
    want, wall1, span1, walls1 = timed(one_device)
    detail = hold_fn(got, want)
    busy, busy1 = busy_ms(run), busy_ms(one_device)

    def ms_list(xs):
        return ", ".join(f"{x:.2f}" for x in xs)
    log(f"phase 9 {name}: {launches} mrf_stage launches; wall median {wall:.2f} ms of "
        f"{TIMED_RUNS} ({ms_list(walls)}; CUDA-event span {span:.2f}), card busy {busy:.2f} ms; "
        f"the single-device run wall {wall1:.2f} ms ({ms_list(walls1)}; span {span1:.2f}), "
        f"busy {busy1:.2f} ms: cost x{wall / wall1:.2f} wall, x{busy / busy1:.2f} busy; {detail}")
    if (launches > 0) != kernel or unfolded:
        raise RuntimeError(f"phase 9 {name}: {launches} mrf_stage launches, kernel path {kernel}")
    return launches


def one_device_synthesize(model, cfg, src, pun, style, n):
    """The single-device pipeline on a LoadedModel packed once (the baseline
    of phase 9's sharded regimes): front, then the vocoder on its packed
    weights, on the model's device."""
    import torch
    from zerovox_tpu_torch.models import hifigan
    from zerovox_tpu_torch.models.pipeline import compute_dtype, front
    dev = model.device
    src, pun, n = (torch.as_tensor(a, device=dev).long() for a in (src, pun, n))
    style = torch.as_tensor(style, device=dev, dtype=torch.float32).to(compute_dtype(cfg))
    mel, mel_len, _ = front(model.params, cfg, src, pun, style, n)
    return hifigan.vocode(model.params, cfg, mel, model.packed), mel, mel_len


def hold_arrays(pairs, gate, what):
    """Each (got, want) float pair within `gate` (np.allclose keywords, or
    an atol); returns max|d| and whether all are bitwise equal."""
    import numpy as np
    worst, bitwise = 0.0, True
    for got, want in pairs:
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{what}: {got.shape} against {want.shape}, or not finite")
        ok = (np.allclose(got, want, **gate) if isinstance(gate, dict)
              else np.abs(got - want).max(initial=0) <= gate)
        if not ok:
            raise RuntimeError(f"{what}: max|d| {np.abs(got - want).max():.3e} beyond {gate}")
        worst = max(worst, float(np.abs(got - want).max(initial=0)))
        bitwise &= np.array_equal(got, want)
    return f"max|d| {worst:.3e} (gate {gate}), bitwise equal: {bitwise}"


def variance_of(cfg, front_fn, rows):
    """Per utterance of the row blocks `rows` ((src, pun, style, lens) on the
    card), what front_fn(*row) tapped (utils.debug.capture_run): the pitch
    and energy predictions, the log-durations and the frame counts, as
    numpy, cut to the utterance's phonemes; and under "front" the tensors a
    one-device back end and energy predictor need to continue from this
    front (its encoder output, pitch, features, log-durations, style and
    phoneme count, on the device that computed them)."""
    from zerovox_tpu_torch.ops.length_regulator import durations_from_log
    from zerovox_tpu_torch.utils.debug import capture_run
    out = []
    for row in rows:
        _, taps = capture_run(front_fn, *row)
        frames = durations_from_log(taps["log_duration"], cfg.max_seq_len)
        for b, n in enumerate(row[3].tolist()):
            u = {k: t[b, :n].float().cpu().numpy() for k, t in
                 (("pitch", taps["pitch"]), ("energy", taps["energy"]), ("frames", frames),
                  ("log_duration", taps["log_duration"]))}
            u["front"] = {k: taps[k][b:b + 1] for k in
                          ("encoder_output", "pitch", "features", "log_duration")}
            u["front"].update(style=row[2][b:b + 1], num_phonemes=row[3][b:b + 1])
            out.append(u)
    return out


def energy_after(cfg, model, fr):
    """The one-device energy predictor on the pitch-updated features of the
    front `fr` (variance_of's "front"): encode's own steps from that
    front's encoder output and pitch buckets, so the input is that front's
    to the bit and only the predictor's sums differ."""
    from zerovox_tpu_torch.models import fs2_encoder
    from zerovox_tpu_torch.ops.misc import bucketize
    enc, dev = model.params["encoder"], model.device
    x = fr["encoder_output"].to(dev)
    features = x + fr["style"].to(dev)[:, None, :].to(x.dtype)
    features = features + enc["pitch_emb"][bucketize(fr["pitch"].to(dev), cfg.ve_n_bins)].to(x.dtype)
    return fs2_encoder.variance_predictor(features, enc["energy_predictor"], cfg)


def back_from(cfg, model, fr):
    """The one-device length regulator, decoder and vocoder (packed weights)
    continuing the front `fr`: (mel, wav) of one utterance, as numpy, the
    full max_seq_len buffer."""
    import torch
    from zerovox_tpu_torch.models import hifigan, styletts_decoder
    from zerovox_tpu_torch.ops import durations_from_log, length_regulate
    dev = model.device
    with torch.inference_mode():
        durations = durations_from_log(fr["log_duration"].to(dev), cfg.max_seq_len)
        hidden, _ = length_regulate(fr["features"].to(dev), durations, cfg.max_seq_len,
                                    num_phonemes=fr["num_phonemes"].to(dev))
        mel = styletts_decoder.decode(model.params, cfg, hidden, fr["style"].to(dev))
        wav = hifigan.vocode(model.params, cfg, mel, model.packed)
    return {"mel": mel[0].float().cpu().numpy(), "wav": wav[0].float().cpu().numpy()}


# a TP prediction this close to one device's (on the same input to the bit
# where a pitch bucket moved: energy_after) differs by the order of float
# sums only; set from phase 9's readings (the largest gap under f32 TP and
# the TF32 probe's, both printed at the end of the phase; PERF.md)
FLIP_DELTA = 1e-4
TP_UTTERANCES = {"same": 0, "moved": 0}     # over every hold_tp of the run
TP_GAPS = {"pitch": 0.0, "energy": 0.0, "log_duration": 0.0}   # largest f32 TP gaps of the run
TF32_GAPS = {}                              # the same, for the TF32 probe's front


def tp_audit(cfg, model, got, want, gaps=TP_GAPS):
    """A TP front's variance_of (`got`) against one device's (`want`, on
    `model`, a LoadedModel): per utterance the pitch or energy buckets and
    frame counts that moved, [(what, phoneme, one device -> TP, |TP - one
    device| of the prediction (the log-duration for a frame count))], and
    for an utterance with a move, the one-device back end continuing the
    TP front (back_from), which the TP answer is held against.  Where a
    pitch bucket moved, the energy is held against the one-device
    predictor on the TP's pitch-updated features (energy_after).  The
    largest gap per prediction goes to `gaps`.  Returns (moves, anchors)."""
    import numpy as np
    import torch
    from zerovox_tpu_torch.ops.misc import bucketize

    def buckets(v):
        return bucketize(torch.as_tensor(v), cfg.ve_n_bins).numpy()
    moves, anchors = [], {}
    for u, (g, w) in enumerate(zip(got, want)):
        f = []
        ref = {"pitch": w["pitch"], "energy": w["energy"], "log_duration": w["log_duration"]}
        if (buckets(g["pitch"]) != buckets(w["pitch"])).any():
            with torch.inference_mode():
                ref["energy"] = energy_after(cfg, model, g["front"])[0, :len(g["energy"])] \
                    .float().cpu().numpy()
        for k in ("pitch", "energy"):
            bg, bw = buckets(g[k]), buckets(w[k])
            f += [(k, int(p), int(bw[p]), int(bg[p]), abs(float(g[k][p] - ref[k][p])))
                  for p in np.flatnonzero(bg != bw)]
        f += [("frames", int(p), int(w["frames"][p]), int(g["frames"][p]),
               abs(float(g["log_duration"][p] - w["log_duration"][p])))
              for p in np.flatnonzero(g["frames"] != w["frames"])]
        for k in gaps:
            gaps[k] = max(gaps[k], float(np.abs(g[k] - ref[k]).max(initial=0)))
        if f:
            anchors[u] = back_from(cfg, model, g["front"])
        moves.append(f)
    return moves, anchors


def hold_tp(got, want, audit, what, key):
    """TP answers (per-utterance arrays, `key` "mel" or "wav") against the
    single device's.  Where no bucket or frame count moved (tp_audit), within
    the f32 TP gate.  Where one moved, the utterance is another input to the
    decoder from there on: each move must be float order (its two
    predictions within FLIP_DELTA), and the answer is held at the same gate
    against the one-device back end continuing the TP front; its distance
    from the one-device answer is reported.  The counts go to
    TP_UTTERANCES."""
    import numpy as np
    moves, anchors = audit
    same, moved = [], []
    for u, (g, w, f) in enumerate(zip(got, want, moves)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        d = float(np.abs(g - w).max(initial=0)) if g.shape == w.shape else None
        ref = anchors[u][key][:len(g)] if f else w
        if (g.shape != ref.shape or not np.isfinite(g).all()
                or not np.allclose(g, ref, **TP_TOL)):
            raise RuntimeError(f"{what}: utterance {u} differs from "
                               + ("the one-device back end on the TP front" if f else
                                  "one device, every bucket as there")
                               + f": max|d| {np.abs(g - ref).max() if g.shape == ref.shape else None}"
                               f" (gate {TP_TOL})")
        if not f:
            same.append(d)
            continue
        d_back = float(np.abs(g - ref).max(initial=0))
        log(f"  {what}: utterance {u}: {len(f)} bucket or frame count(s) moved under TP ("
            + "; ".join(f"{k} of phoneme {p}: {a} -> {b}, predictions {e:.1e} apart"
                        for k, p, a, b, e in f[:4])
            + f"{' ...' if len(f) > 4 else ''}); max|d| {d_back:.3e} from the one-device back "
            f"end on the TP front; "
            + (f"{d:.3e} from one device" if d is not None else "another length than one device"))
        unexplained = [x for x in f if x[4] > FLIP_DELTA]
        if unexplained:
            raise RuntimeError(f"{what}: utterance {u}: a bucket moved by more than float "
                               f"order: {unexplained}")
        moved.append(d_back)
    TP_UTTERANCES["same"] += len(same)
    TP_UTTERANCES["moved"] += len(moved)
    return (f"{len(same)} utterance(s) with every bucket as on one device within {TP_TOL}: "
            f"max|d| {max(same, default=0.0):.3e}; {len(moved)} with a moved bucket, within "
            f"it of the one-device back end on the TP front: max|d| {max(moved, default=0.0):.3e}")


def tf32_probe(cfg, model, tp_front, rows, want):
    """The gate's power: the TP front with TF32 products switched on (a fault
    the port once had: a raced cuDNN TF32 switch) moves the predictions by
    TF32_GAPS; phase 9 fails unless that is beyond FLIP_DELTA and every
    f32 TP gap below it."""
    import torch
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        got = sum((variance_of(cfg, tp_front[i], [r]) for i, r in enumerate(rows)), [])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    TF32_GAPS.update(pitch=0.0, energy=0.0, log_duration=0.0)
    tp_audit(cfg, model, got, want, gaps=TF32_GAPS)


def sharded_regimes(cfg, params, meshes, precision):
    """make_sharded_synthesize on each (name, mesh, kwargs), a batch of 4
    mixed lengths, held against the single-device pipeline (a LoadedModel
    packed once) on each data row (TP: per utterance, hold_tp); returns
    the launches."""
    import numpy as np
    import torch
    from zerovox_tpu_torch.models.pipeline import compute_dtype, front, load_model
    from zerovox_tpu_torch.parallel import make_sharded_synthesize, param_partition_specs
    from zerovox_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from zerovox_tpu_torch.parallel.tp import front_tp, tp_view
    src, pun, style, lens = mixed_batch(cfg, 4, 90)
    launches = 0
    for name, mesh, kw in meshes:
        tp = mesh.shape[MODEL_AXIS] > 1
        sp, fn = make_sharded_synthesize(cfg, mesh, params, **kw)
        one = load_model(params, cfg, mesh.devices[0, 0])
        n = mesh.shape[DATA_AXIS]
        rows = [tuple(a[j * 4 // n:(j + 1) * 4 // n] for a in (src, pun, style, lens))
                for j in range(n)]
        if tp:
            specs = param_partition_specs(params)
            views = [tp_view([m.params for m in sp[i]], specs) for i in range(n)]

            def on(dev, r):
                return tuple(torch.as_tensor(a, device=dev).to(t) for a, t in
                             zip(r, (torch.long, torch.long, compute_dtype(cfg), torch.long)))
            # each row's TP front on its row's devices; one device's front where it lies
            tp_front = [lambda *x, v=v: front_tp(v, cfg, *x) for v in views]
            tp_rows = [on(mesh.devices[i, 0], r) for i, r in enumerate(rows)]
            got_v = sum((variance_of(cfg, tp_front[i], [r]) for i, r in enumerate(tp_rows)), [])
            want_v = variance_of(cfg, lambda *x: front(one.params, cfg, *x),
                                 [on(one.device, r) for r in rows])
            audit = tp_audit(cfg, one, got_v, want_v)
            if not TF32_GAPS:
                tf32_probe(cfg, one, tp_front, tp_rows, want_v)

            def hold_fn(got, want, audit=audit, name=name):
                wav = [w[0][b].float().cpu().numpy() for w in want for b in range(len(w[0]))]
                mel = [w[1][b].float().cpu().numpy() for w in want for b in range(len(w[1]))]
                return ("mel: " + hold_tp(got.mel.float().cpu().numpy(), mel, audit,
                                          name + " mel", "mel")
                        + "; wav: " + hold_tp(got.wav.float().cpu().numpy(), wav, audit,
                                               name + " wav", "wav"))
        else:
            gate = WAV_ATOL_BF16 if precision == "bfloat16" else STREAM_TOL

            def hold_fn(got, want, gate=gate, name=name):
                if not np.array_equal(got.mel_len.cpu().numpy(),
                                      torch.cat([w[2] for w in want]).cpu().numpy()):
                    raise RuntimeError(f"{name}: mel_len differs from the single-device run")
                return ("mel " + hold_arrays([(got.mel.float().cpu(), torch.cat(
                    [w[1] for w in want]).float().cpu())], gate, name)
                    + "; wav " + hold_arrays([(got.wav.float().cpu(), torch.cat(
                        [w[0] for w in want]).float().cpu())], gate, name))
        launches += regime(
            f"{precision} make_sharded_synthesize {name} (mesh {mesh.shape}, batch 4)",
            lambda: fn(sp, src, pun, style, lens),
            lambda: [one_device_synthesize(one, cfg, *r) for r in rows],
            hold_fn,
            kernel=kw.get("time_shard_vocoder", True) is not False)
        del sp, fn, one
        torch.cuda.empty_cache()
    return launches


def tp_engine_audit(cfg, model, engine, batch):
    """tp_audit of a TPServingEngine's front against one device's (on
    `model`, a LoadedModel) for `batch`, on the rows the engine runs it in
    (ladder-padded, split over the data axis)."""
    import numpy as np
    import torch
    from zerovox_tpu_torch.models.pipeline import front
    from zerovox_tpu_torch.parallel import param_partition_specs
    from zerovox_tpu_torch.parallel.mesh import DATA_AXIS
    from zerovox_tpu_torch.parallel.tp import front_tp, tp_view
    n = engine.mesh.shape[DATA_AXIS]
    specs = param_partition_specs(model.params)
    got, want = [], []
    for padded, real in engine._ladder_chunks(range(len(batch[0]))):
        # the ladder-padded rows (the first `real` are the request's), split
        # over the data axis as the engine splits them
        for i, pos in enumerate(np.array_split(np.arange(len(padded)), n)):
            idx = np.asarray(padded)[pos]

            def row(dev):
                return [tuple(torch.as_tensor(a[idx], device=dev).to(t) for a, t in
                              zip(batch, (torch.long, torch.long, torch.float32, torch.long)))]
            view = tp_view([m.params for m in engine.params[i]], specs)
            g = variance_of(cfg, lambda *r: front_tp(view, cfg, *r),
                            row(engine.params[i, 0].device))
            w = variance_of(cfg, lambda *r: front(model.params, cfg, *r), row(model.device))
            got += [g[j] for j, p in enumerate(pos) if p < real]
            want += [w[j] for j, p in enumerate(pos) if p < real]
    return tp_audit(cfg, model, got, want)


def multi_device_path(cfg, params, params16, tiny_model, seen, held):
    """Phase 9: every multi-device regime on meshes of the card repeated
    (and of distinct cards where the machine has them), each held against
    the single-device run on the card; returns (f32, bf16) launches."""
    import numpy as np
    import torch
    from zerovox_tpu_torch.models import hifigan
    from zerovox_tpu_torch.models.pipeline import synthesize
    from zerovox_tpu_torch.models.streaming import chunk_plan
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    from zerovox_tpu_torch.params import init_params, load_params, vocoder_stage_channels
    from zerovox_tpu_torch.parallel import PipelinedTTS, TimeParallelVocoder, make_mesh
    from zerovox_tpu_torch.runtime.client import TTSClient
    from zerovox_tpu_torch.runtime.engine import TTSEngine
    from zerovox_tpu_torch.runtime.server import TTSServer
    from zerovox_tpu_torch.runtime.tp_engine import TPServingEngine

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()

    def mesh(d, m, distinct=False):
        devs = ([torch.device("cuda", i) for i in range(d * m)] if distinct
                else [card] * (d * m))
        return make_mesh(data=d, model=m, devices=devs)

    shapes = [("DP (4,1)", (4, 1), {}), ("TP (2,2) time-sharded", (2, 2), {}),
              ("TP (1,4) time-sharded", (1, 4), {}),
              ("TP (2,2) channel-sharded", (2, 2), dict(time_shard_vocoder=False))]
    meshes = [(n, mesh(*dm), kw) for n, dm, kw in shapes]
    meshes += [(n + " on distinct cards", mesh(*dm, distinct=True), kw)
               for n, dm, kw in shapes if dm[0] * dm[1] <= n_cards > 1]
    f32 = sharded_regimes(cfg, params, meshes, "float32")
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    bf16 = sharded_regimes(cfg16, params16, [("DP (4,1)", mesh(4, 1), {})], "bfloat16")

    # the DP serving engine over its whole scaled ladder, against the one-device engine
    single = TTSEngine(params, cfg)
    dp = TTSEngine(params, cfg, mesh=mesh(4, 1))
    if dp.batch_ladder != tuple(4 * b for b in LADDER):
        raise RuntimeError(f"DP engine ladder {dp.batch_ladder}")
    t0 = time.perf_counter()
    dp.warmup(batch=dp.batch_ladder[-1])
    log(f"phase 9 TTSEngine(mesh=(4,1)) warm-up over ladder {dp.batch_ladder} x buckets "
        f"{dp.mel_buckets}: {time.perf_counter() - t0:.2f} s")
    for rung in dp.batch_ladder:
        batch = mixed_batch(cfg, rung, 100 + rung)
        f32 += regime(f"float32 TTSEngine(mesh=(4,1)).synthesize_packed B={rung}",
                      lambda: dp.synthesize_packed(*batch), lambda: single.synthesize_packed(*batch),
                      lambda got, want: hold_arrays(zip(got[0], want[0]), STREAM_TOL,
                                                    f"DP engine B={rung}"))
    del dp

    # the TP serving engine on (2, 2), with a reload
    tpe = TPServingEngine(params, cfg, mesh(2, 2))
    t0 = time.perf_counter()
    tpe.warmup(batch=tpe.batch_ladder[-1])
    log(f"phase 9 TPServingEngine((2,2)) warm-up over ladder {tpe.batch_ladder}: "
        f"{time.perf_counter() - t0:.2f} s")
    for B in (1, 3):
        batch = mixed_batch(cfg, B, 110 + B)
        audit = tp_engine_audit(cfg, single.model, tpe, batch)
        f32 += regime(f"float32 TPServingEngine((2,2)).synthesize B={B}",
                      lambda: tpe.synthesize(*batch), lambda: single.synthesize(*batch),
                      lambda got, want: hold_tp(got[0], want[0], audit, f"TP engine B={B}",
                                                "wav"))
    other = init_params(cfg, seed=1, device="cuda")
    tpe.reload_params(other)
    single.reload_params(other)
    batch = mixed_batch(cfg, 2, 120)
    audit = tp_engine_audit(cfg, single.model, tpe, batch)
    f32 += regime("float32 TPServingEngine((2,2)) after reload_params, B=2",
                  lambda: tpe.synthesize(*batch), lambda: single.synthesize(*batch),
                  lambda got, want: hold_tp(got[0], want[0], audit, "TP engine after reload",
                                            "wav"))
    single.reload_params(params)
    del tpe, other

    # the two-stage pipeline, front and back on the one card
    utts = [tuple(a[i:i + 1] for a in mixed_batch(cfg, 8, 130)) for i in range(8)]
    pipe = PipelinedTTS(params, cfg, front_device=card, back_device=card, max_in_flight=4)
    pipe.warmup()
    f32 += regime("float32 PipelinedTTS (front = back = cuda:0), 8 utterances, max_in_flight 4",
                  lambda: pipe.run(utts),
                  lambda: [one_device_synthesize(single.model, cfg, *u) for u in utts],
                  lambda got, want: hold_arrays([(g[0], w[0].cpu()) for g, w in zip(got, want)],
                                                STREAM_TOL, "pipeline"))
    del pipe

    # the time-parallel vocoder over 4, on a full-length request's mel
    src, pun, style, lens = mixed_batch(cfg, 1, 140)
    mel = synthesize(params, cfg, src, pun, style, lens).mel
    tpv = TimeParallelVocoder(params, cfg, devices=[card] * 4, chunk_frames=TPV_CHUNK,
                              overlap=TPV_OVERLAP)
    tpv.warmup()
    windows = sorted({w[1] for w in chunk_plan(cfg.max_seq_len, -(-cfg.max_seq_len // TPV_CHUNK),
                                               TPV_CHUNK, TPV_OVERLAP)})
    f32 += regime(f"float32 TimeParallelVocoder over 4 (windows {windows}), 1500 frames",
                  lambda: tpv.vocode(mel),
                  lambda: hifigan.vocode(params, cfg, mel, single.vocoder_packed).cpu().numpy(),
                  lambda got, want: hold_arrays([(got, want)], STREAM_TOL, "time-parallel"))
    del tpv

    if n_cards > 1:    # the same regimes on distinct cards, where the machine has them
        cards = [torch.device("cuda", i) for i in range(min(4, n_cards))]
        tpv = TimeParallelVocoder(params, cfg, devices=cards, chunk_frames=TPV_CHUNK,
                                  overlap=TPV_OVERLAP)
        tpv.warmup()
        f32 += regime(f"float32 TimeParallelVocoder over {len(cards)} distinct cards",
                      lambda: tpv.vocode(mel),
                      lambda: hifigan.vocode(params, cfg, mel, single.vocoder_packed).cpu().numpy(),
                      lambda got, want: hold_arrays([(got, want)], STREAM_TOL, "time-parallel"))
        pipe = PipelinedTTS(params, cfg, front_device=cards[0], back_device=cards[1],
                            max_in_flight=4)
        pipe.warmup()
        f32 += regime("float32 PipelinedTTS (front cuda:0, back cuda:1), 8 utterances",
                      lambda: pipe.run(utts),
                      lambda: [one_device_synthesize(single.model, cfg, *u) for u in utts],
                      lambda got, want: hold_arrays([(g[0], w[0].cpu()) for g, w in
                                                     zip(got, want)], STREAM_TOL, "pipeline"))
        dp = TTSEngine(params, cfg, mesh=mesh(len(cards), 1, distinct=True))
        dp.warmup(batch=dp.batch_ladder[-1])
        batch = mixed_batch(cfg, 8 * len(cards), 170)
        f32 += regime(f"float32 TTSEngine(mesh=({len(cards)},1) distinct cards)."
                      f"synthesize_packed B={8 * len(cards)}",
                      lambda: dp.synthesize_packed(*batch),
                      lambda: single.synthesize_packed(*batch),
                      lambda got, want: hold_arrays(zip(got[0], want[0]), STREAM_TOL,
                                                    "DP engine on distinct cards"))
        del tpv, pipe, dp

    # daemons: (2, 1) with two concurrent /stream sessions on the rotation; (1, 2)
    src, pun, style, lens = mixed_batch(cfg, 1, 150)          # one full-length utterance
    request = (src[0], style[0], pun[0])
    want, _ = single.synthesize(src, pun, style, lens, pcm16=True)
    for d, m, distinct in ((2, 1, False), (1, 2, False)) + (((2, 1, True),) if n_cards > 1 else ()):
        t0 = time.perf_counter()
        ms.mrf_stage.launches = 0
        server = TTSServer(params, cfg, port=0, mesh=mesh(d, m, distinct))
        up = time.perf_counter() - t0
        sessions = []
        rotate = server.stream.session_device
        server.stream.session_device = lambda device=None: sessions.append(rotate(device)) \
            or sessions[-1]
        server.start()
        try:
            client = TTSClient(*server.address, timeout=120)
            t0 = time.perf_counter()
            answer, _ = client.synthesize(*request)
            wall = 1e3 * (time.perf_counter() - t0)
            streams = in_threads(lambda i: np.concatenate(list(client.stream(*request))), 2)
            launches = ms.mrf_stage.launches         # the daemon's, its warm-up included
            if m > 1:          # TP: the daemon against its engine, the engine against one device
                direct, _ = server.engine.synthesize(src, pun, style, lens, pcm16=True)
                d_syn = hold(answer, direct[0], PCM_LSB["float32"], f"({d},{m}) daemon")
                audit = tp_engine_audit(cfg, single.model, server.engine,
                                        (src, pun, style, lens))
                log("phase 9 " + hold_tp([server.engine.synthesize(src, pun, style, lens)[0][0]],
                                         [single.synthesize(src, pun, style, lens)[0][0]], audit,
                                         f"({d},{m}) TP daemon's engine", "wav"))
            else:
                d_syn = hold(answer, want[0], PCM_LSB["float32"], f"({d},{m}) /synthesize")
            # /stream runs the one-device path on the mesh's first device (TP too)
            single_answer = want[0] if m > 1 else answer
            d_str = max(hold(s_[:len(single_answer)], single_answer, PCM_LSB_STREAM["float32"],
                             f"({d},{m}) /stream") for s_ in streams)
        finally:
            server.shutdown()
        f32 += launches
        log(f"phase 9 float32 TTSServer(mesh=({d},{m}){' distinct cards' if distinct else ''}) "
            f"({type(server.engine).__name__}): up in "
            f"{up:.2f} s (warm-up included), /synthesize {wall:.2f} ms host clock, {d_syn} LSB "
            f"from the engine; two concurrent /stream sessions on devices "
            f"{[str(x) for x in sessions]} (rotation over {server.stream.devices}), {d_str} LSB "
            f"from {'the one-device engine' if m > 1 else '/synthesize'}; {launches} mrf_stage "
            f"launches (warm-up included)")
        if launches == 0 or (m == 1 and len(sessions) != 2):
            raise RuntimeError(f"({d},{m}) daemon: {launches} launches, sessions {sessions}")
    del single

    # the repair: a TINY checkpoint served on the card takes the plain route for every stage
    tcfg, tparams_ = load_params(tiny_model, device="cuda")
    if any(hifigan.stage_routes(tparams_, tcfg)):
        raise RuntimeError("a TINY stage is routed to the kernel")
    tsrc, tpun, tstyle, tlens = mixed_batch(tcfg, 2, 160)
    ms.mrf_stage.launches = 0
    tiny = TTSServer(tparams_, tcfg, port=0)
    tiny.start()
    try:
        tclient = TTSClient(*tiny.address, timeout=120)
        answer, _ = tclient.synthesize(tsrc[0], tstyle[0], tpun[0])
        streamed = np.concatenate(list(tclient.stream(tsrc[0], tstyle[0], tpun[0])))
        wavs, mel_len = tiny.engine.synthesize(tsrc, tpun, tstyle, tlens)
    finally:
        tiny.shutdown()
    tiny_launches = ms.mrf_stage.launches
    with plain_vocoder():
        ref = synthesize(tiny.engine.params, tcfg, tsrc, tpun, tstyle, tlens)
    detail = hold_arrays([(w, r[:len(w)].cpu()) for w, r in zip(wavs, ref.wav)], PIPELINE_WAV_ATOL,
                         "TINY engine against the plain pipeline")
    d_str = hold(streamed[:len(answer)], answer, PCM_LSB_STREAM["float32"], "TINY /stream")
    log(f"phase 9 TINY checkpoint on the card (stage widths "
        f"{[c for _, c in vocoder_stage_channels(tcfg)]}, all on the plain route): TTSServer warm-up, /synthesize and /stream ({d_str} LSB "
        f"apart), engine B=2 mel_len {mel_len.tolist()} against the plain pipeline: {detail}; "
        f"{tiny_launches} mrf_stage launches")
    if tiny_launches:
        raise RuntimeError(f"the TINY server launched the kernel {tiny_launches} times")

    def gaps(g):
        return ", ".join(f"{k} {v:.3e}" for k, v in g.items())
    log(f"phase 9 TP against one device, float32: {TP_UTTERANCES['same']} utterance "
        f"answers with every pitch and energy bucket and frame count as on one device, "
        f"{TP_UTTERANCES['moved']} with one moved by float order (reported above); the "
        f"largest prediction gaps under f32 TP: {gaps(TP_GAPS)}; with TF32 products (the "
        f"probe): {gaps(TF32_GAPS)}; FLIP_DELTA {FLIP_DELTA:.0e}")
    if not TP_UTTERANCES["same"]:
        raise RuntimeError("phase 9: a bucket moved under TP in every utterance")
    if not max(TP_GAPS.values()) < FLIP_DELTA < max(TF32_GAPS.values()):
        raise RuntimeError("phase 9: FLIP_DELTA does not lie between the f32 TP gaps and the "
                           "TF32 probe's")
    hold_launched_shapes(seen, held, "phase 9")
    log(f"phase 9 (multi-device serving) {time.perf_counter() - t_phase:.1f} s: mrf_stage "
        f"launches f32 {f32}, bf16 {bf16}")
    return f32, bf16


# --------------------------------------------------------------------------
# phase 10: training on a mesh
# --------------------------------------------------------------------------

MESH_B = 4                      # phase 10 (a)'s global batch
MESH_ADAM_LR = 1e-4             # its AdamW steps (the CLI's default lr)
COMPILE_CACHE_PROBE = (
    "import json, sys, time\n"
    "t0 = time.perf_counter()\n"
    "sys.path.insert(0, sys.argv[2])\n"
    "from zerovox_tpu_torch.utils import enable_compile_cache\n"
    "from zerovox_tpu_torch.ops.cuda import mrf_stage\n"
    "from zerovox_tpu_torch.io import native\n"
    "enable_compile_cache(sys.argv[1])\n"
    "lib = mrf_stage.library()\n"
    "assert native.available(), native.build_error\n"
    "print(json.dumps({'kernel': lib.build_seconds, 'native': native.build_seconds,\n"
    "                  'process': time.perf_counter() - t0}))\n")


def capture_sgd(lr, grads):
    """SGD whose update also keeps the whole gradient tree it was given (the
    step's (p - p') / lr before the subtraction rounds it)."""
    from zerovox_tpu_torch.params import tree_map
    from zerovox_tpu_torch.training.train import Optimizer

    def update(g, state, params):
        grads.append(params.layout.gather(g))
        return tree_map(lambda x: -lr * x, g), state
    return Optimizer(lambda p: {}, update)


def gradient_rule(want, got, cfg):
    """tests/test_torch_training.py's rule, per leaf: max|d| <= 1e-3 *
    max|want_leaf| + 1e-6 * max|want|.  (worst max|d| / that bound, leaf,
    leaves outside)."""
    dist = {n: ((a.double() - b.double()).abs().max().item(), a.abs().max().item())
            for (n, a), (_, b) in zip(named_leaves(want, cfg), named_leaves(got, cfg))}
    gmax = max(m for _, m in dist.values())
    ratios = sorted((d / (1e-3 * m + 1e-6 * gmax), n) for n, (d, m) in dist.items())
    return ratios[-1][0], ratios[-1][1], sum(r > 1 for r, _ in ratios)


def f64_median(g, g64, cfg):
    """Median over the leaves (above 1e-6 of the largest) of max|g - g64| /
    max|g64_leaf|: phase 8 (c)'s reading of a gradient's float32 noise."""
    import numpy as np
    dist = grad_distances(g, g64, cfg)
    gmax = max(m for _, m in dist.values())
    return float(np.median([d / m for d, m in dist.values() if m > 1e-6 * gmax]))


def sgd_gradient(make, batch):
    """(losses, whole gradient tree, initial state) of one SGD step of the
    step `make(optimizer)` builds."""
    grads = []
    state, step = make(capture_sgd(1.0, grads))
    _, losses = step(state, batch)
    return {k: float(v) for k, v in losses.items()}, grads[0], state


def variance_buckets(cfg, state, batch):
    """The pitch and energy buckets of the step's forward on `batch`, row by
    row as the step splits it (the variance adaptor's taps), on the host."""
    import torch
    from zerovox_tpu_torch.ops.misc import bucketize
    from zerovox_tpu_torch.training.train import TrainBatch, _teacher_forced
    from zerovox_tpu_torch.utils.debug import capture_run
    layout = state.params.layout
    rows = layout.split_batch(TrainBatch(*(torch.as_tensor(x) for x in batch)))
    out = {"pitch": [], "energy": []}
    with torch.no_grad():
        for tree, b in zip(layout.replicas(state.params), rows):
            _, taps = capture_run(_teacher_forced, layout.view(tree) if layout.tp else tree,
                                  cfg, b, False, layout.tp)
            for k in out:
                out[k].append(bucketize(taps[k], cfg.ve_n_bins).cpu())
    return {k: torch.cat(v) for k, v in out.items()}


def bucket_moves(cfg, one, got, lens):
    """The pitch and energy buckets (of real phonemes) that differ."""
    import torch
    mask = torch.arange(cfg.max_n_phonemes)[None, :] < torch.as_tensor(lens)[:, None]
    return {k: int(((one[k] != got[k]) & mask).sum()) for k in one}


def mesh_step_regime(label, make, batch, cfg, card):
    """One regime of phase 10 (a): an SGD step that keeps its gradient, its
    forward's variance buckets, two AdamW steps, then 3 timed AdamW steps
    (host clock, synchronised; the median), one under torch.profiler (busy
    ms) and the peak memory."""
    import statistics
    import torch
    from zerovox_tpu_torch.training.train import make_optimizer
    loss, grads, state = sgd_gradient(make, batch)
    buckets = variance_buckets(cfg, state, batch)
    del state
    state, step = make(make_optimizer(MESH_ADAM_LR))
    for _ in range(2):
        state, _ = step(state, batch)
    adam = state.params.layout.gather(state.params)
    cards = range(torch.cuda.device_count())

    def synced():                 # a step ends on every card of a mesh of distinct cards
        step(state, batch)
        for i in cards:
            torch.cuda.synchronize(i)
    synced()
    base = max(torch.cuda.memory_allocated(i) for i in cards)
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    walls = [timed_run(synced)[1] for _ in range(TIMED_RUNS)]
    peak = max(torch.cuda.max_memory_allocated(i) for i in cards)
    busy = busy_ms(synced)
    wall = statistics.median(walls)
    log(f"  (a) {label}: loss {loss['total']:.7f}; AdamW step wall median {wall:.1f} ms "
        f"({['%.1f' % w for w in walls]}), busy {busy:.1f} ms (summed over the cards), peak "
        f"memory {peak / 2**30:.2f} GiB on the fullest card ({base / 2**30:.2f} GiB held "
        f"before) [{card}]")
    del state, step
    return {"loss": loss, "grads": grads, "buckets": buckets, "adam": adam, "wall": wall,
            "busy": busy, "peak": peak}


def mesh_steps(cfg, params, dev, distinct, card, failures):
    """Phase 10 (a): make_sharded_train_step on meshes of `dev` repeated (of
    four distinct cards where `distinct`) against make_train_step on `dev`,
    4 rows with the STFT loss.  The gates of the CPU tests (loss rtol 1e-5, the SGD
    step per leaf within tests/test_torch_training.py's rule) hold the step
    in float64: the same code, where rounding cannot move a loss by 1e-5 or
    a gradient by 1e-3 of a leaf.  In float32 this loss is not that well
    conditioned at random weights (a row whose mel is mostly padding: its
    instance norms divide near-constant channels), so another split of the
    same rows moves it (printed: the one device's rows one at a time); the
    float32 step is held at 1e-3 of the float64 loss and at AdamW's 2 * lr
    per step, and its gradient's distances are printed.  Appends what fails
    to `failures`."""
    import numpy as np
    import torch
    from zerovox_tpu_torch.parallel import make_mesh, single_device_mesh
    from zerovox_tpu_torch.params import tree_leaves, tree_map
    from zerovox_tpu_torch.training import make_sharded_train_step, make_train_step
    from zerovox_tpu_torch.training.cli import synthetic_dataset
    from zerovox_tpu_torch.training.train import TrainBatch, sharded_losses
    batch = synthetic_dataset(cfg, MESH_B, seed=10)
    lens = np.linspace(cfg.max_n_phonemes, cfg.max_n_phonemes // 2, MESH_B).astype(np.int32)
    batch = batch._replace(num_phonemes=lens)
    batch64 = TrainBatch(*(x.astype(np.float64) if x.dtype == np.float32 else x for x in batch))
    params64 = tree_map(lambda t: t.double(), params)
    shapes = ((4, 1), (2, 2)) if distinct else ((2, 1), (1, 2), (2, 2))
    where = "distinct cards" if distinct else f"{dev} repeated"
    one = mesh_step_regime("one device", lambda opt: make_train_step(cfg, params, opt, dev),
                           batch, cfg, card)
    l64, g64, _ = sgd_gradient(lambda opt: make_sharded_train_step(
        cfg, single_device_mesh(dev), params64, opt), batch64)
    state, _ = make_sharded_train_step(cfg, make_mesh(MESH_B, 1, devices=[dev] * MESH_B), params)
    alone = sharded_losses(state.params.layout, state.params, cfg,
                           TrainBatch(*(torch.as_tensor(x) for x in batch)))
    del state
    f64_rel = lambda loss: max(abs(float(loss[k]) - l64[k]) / abs(l64[k])       # noqa: E731
                               for k in l64)
    log(f"  (a) one device: float64 loss {l64['total']:.12f}; float32 loss worst term rel to "
        f"float64 {f64_rel(one['loss']):.2e}, the same rows one at a time (B=1 each, the loss "
        f"from their sums) {f64_rel(alone):.2e}; float32 gradient's median distance to float64 "
        f"{f64_median(one['grads'], g64, cfg):.3e} of a leaf (phase 8 (c)'s reading)")
    if not max(f64_rel(one["loss"]), f64_rel(alone)) <= 1e-3:
        failures.append(f"(a) one device: float32 loss rel to float64 {f64_rel(one['loss']):.2e},"
                        f" its rows one at a time {f64_rel(alone):.2e}")
    for d, m in shapes:
        devs = None if distinct else [dev] * (d * m)
        mesh = make_mesh(d, m, devices=devs)
        label = f"({d},{m}) {where}"
        m64, h64, _ = sgd_gradient(lambda opt: make_sharded_train_step(
            cfg, mesh, params64, opt), batch64)
        rel64 = max(abs(m64[k] - l64[k]) / abs(l64[k]) for k in l64)
        worst64, leaf64, outside64 = gradient_rule(g64, h64, cfg)
        del h64
        r = mesh_step_regime(label, lambda opt: make_sharded_train_step(cfg, mesh, params, opt),
                             batch, cfg, card)
        rel = max(abs(r["loss"][k] - one["loss"][k]) / abs(one["loss"][k]) for k in one["loss"])
        moved = bucket_moves(cfg, one["buckets"], r["buckets"], lens)
        worst, leaf, outside = gradient_rule(one["grads"], r["grads"], cfg)
        adam = max((a - b).abs().max().item() for a, b in
                   zip(tree_leaves(one["adam"]), tree_leaves(r["adam"])))
        log(f"  (a) {label} against one device, float64: loss worst term rel {rel64:.2e} (gate "
            f"1e-5), SGD step per leaf worst {worst64:.2e} of the rule 1e-3 max|g_leaf| + 1e-6 "
            f"max|g| ({leaf64}; {outside64} leaves outside); float32: loss worst term rel "
            f"{rel:.2e} to one device, {f64_rel(r['loss']):.2e} to float64 (gate 1e-3), variance "
            f"buckets moved {moved}, SGD step per leaf worst {worst:.3f} of the rule ({leaf}; "
            f"{outside} leaves outside), "
            f"median distance to float64 {f64_median(r['grads'], g64, cfg):.3e}, 2 AdamW steps "
            f"params max|d| {adam:.3e} (gate 2 * lr * 2 = {4 * MESH_ADAM_LR:.0e}); wall "
            f"x{r['wall'] / one['wall']:.2f}, busy x{r['busy'] / one['busy']:.2f}, peak memory "
            f"x{r['peak'] / one['peak']:.2f}")
        if not (rel64 <= 1e-5 and outside64 == 0 and adam <= 4 * MESH_ADAM_LR
                and f64_rel(r["loss"]) <= 1e-3):
            failures.append(f"(a) {label}: float64 loss rel {rel64:.2e}, {outside64} leaves "
                            f"outside the rule (worst {worst64:.2e}, {leaf64}); float32 loss rel "
                            f"to float64 {f64_rel(r['loss']):.2e}, AdamW max|d| {adam:.3e}")
        del r
    del one, g64, params64
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def mesh_training_path(cfg, params, model, tmp, card, seen, held):
    """Phase 10: (a) make_sharded_train_step on meshes against the one-device
    step, (b) the training CLI as two processes, launched and resumed (and
    on four cards the port's two-process worker), (c) --compile-cache across two fresh
    processes, (d) the native loader against the numpy one.  Returns the
    mrf_stage launches of the engine served from (b)'s export."""
    import functools
    import statistics
    import torch
    from zerovox_tpu_torch import params as params_mod
    from zerovox_tpu_torch.io import native
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    from zerovox_tpu_torch.params import load_params, tree_leaves
    from zerovox_tpu_torch.runtime.client import TTSClient
    from zerovox_tpu_torch.runtime.engine import TTSEngine
    from zerovox_tpu_torch.runtime.server import TTSServer
    from zerovox_tpu_torch.tools.distributed_worker import launch

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    distinct = n_cards >= 4
    cuda0 = torch.device("cuda", 0)
    failures = []
    # (c) starts first: its cold nvcc runs on the host's cores while (a) runs
    cache_dir = os.path.join(tmp, "compile_cache")
    probe = [sys.executable, "-c", COMPILE_CACHE_PROBE, cache_dir, str(ROOT)]
    t_cold = time.perf_counter()
    cold = subprocess.Popen(probe, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    mesh_steps(cfg, params, cuda0, distinct, card, failures)
    log(f"  (a) {time.perf_counter() - t0:.1f} s")

    # (b) the training CLI as two processes on the card(s), launched then resumed
    ck, out = os.path.join(tmp, "mesh_ck"), os.path.join(tmp, "mesh_trained.gguf")
    argv = [sys.executable, "-m", "zerovox_tpu_torch.training.cli", "--synthetic", "8",
            "--batch-size", "8", "--no-stft", "--epochs", "1", "--checkpoint-dir", ck,
            "--checkpoint-every", "1", "--export", out]
    if distinct:
        argv += ["--mesh", "1,2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if distinct:                  # two processes of two cards each
        env["LOCAL_WORLD_SIZE"] = "2"
    backend = "nccl" if distinct else "gloo"
    t_b = time.perf_counter()
    for i, want in ((1, 1), (2, 2)):
        t0 = time.perf_counter()
        runs = launch(argv, 2, timeout=600, cwd=ROOT, env=env)
        wall = time.perf_counter() - t0
        finals = []
        for rank, (rc, _, err) in enumerate(runs):
            lines = [ln for ln in err.splitlines()
                     if ln.startswith(("train:", "fit:", "distributed:"))]
            for ln in lines:
                log(f"    cli run {i} rank {rank}: {ln}")
            final = [ln.split("final train loss")[1].split()[0] for ln in lines
                     if "final train loss" in ln]
            if rc != 0 or not final or f"train: {want} total steps" not in err \
                    or f"backend {backend}" not in err \
                    or (i == 2) != ("resumed from step 1" in err):
                raise RuntimeError(f"(b) two-process training CLI run {i} rank {rank}: rc {rc}"
                                   f"\n{err[-3000:]}")
            finals.append(final[0])
        if finals[0] != finals[1]:
            raise RuntimeError(f"(b) run {i}: the ranks' final losses differ: {finals}")
        log(f"  (b) two-process training CLI run {i} ({backend}): rc 0 in both, {want} total "
            f"steps, the same final loss {finals[0]} in both; {wall:.1f} s for the two "
            f"processes [{card}]")
    if distinct:   # the port's two-process worker over nccl (gloo: the CPU tests run it)
        t0 = time.perf_counter()
        runs = launch([sys.executable, "-m", "zerovox_tpu_torch.tools.distributed_worker",
                       "--model", "2"], 2, timeout=300, cwd=ROOT, env=env)
        checks = []
        for rank, (rc, stdout, err) in enumerate(runs):
            if rc != 0:
                raise RuntimeError(f"(b) distributed worker rank {rank}: rc {rc}\n{err[-3000:]}")
            checks.append(sorted(ln for ln in stdout.splitlines() if ln.startswith("CHECK ")))
        if checks[0] != checks[1] or len(checks[0]) != 5:
            raise RuntimeError(f"(b) the worker's checks differ between ranks: {checks}")
        log(f"  (b) two-process worker ({backend}): {'; '.join(checks[0])} in both ranks "
            f"({time.perf_counter() - t0:.1f} s)")
    # the export, served through the kernel by a one-card engine
    ms.mrf_stage.launches = ms.mrf_stage_unfolded.launches = 0
    tcfg, tparams_ = load_params(out, device="cuda")
    if tcfg != cfg:
        raise RuntimeError("(b) the exported GGUF has another geometry")
    compare_pipelines(TTSEngine(tparams_, tcfg))
    served = ms.mrf_stage.launches
    if not served or ms.mrf_stage_unfolded.launches:
        raise RuntimeError(f"(b) the engine on the export launched mrf_stage {served} times")
    hold_launched_shapes(seen, held, "phase 10")
    log(f"  (b) the export served by a one-card TTSEngine: {served} mrf_stage launches; (b) "
        f"{time.perf_counter() - t_b:.1f} s")
    del tparams_

    # (c) --compile-cache: the cold process's build, then a second fresh process
    stdout, err = cold.communicate(timeout=600)
    if cold.returncode != 0:
        raise RuntimeError(f"(c) cold compile-cache process: rc {cold.returncode}\n{err[-3000:]}")
    t_cold = time.perf_counter() - t_cold
    c1 = json.loads(stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    warm = subprocess.run(probe, capture_output=True, text=True, timeout=600)
    t_warm = time.perf_counter() - t0
    if warm.returncode != 0:
        raise RuntimeError(f"(c) warm compile-cache process: rc {warm.returncode}\n"
                           f"{warm.stderr[-3000:]}")
    c2 = json.loads(warm.stdout.strip().splitlines()[-1])
    log(f"  (c) --compile-cache {os.path.basename(cache_dir)}: cold process build_seconds "
        f"kernel {c1['kernel']:.1f} s, native {c1['native']:.2f} s ({c1['process']:.1f} s from "
        f"its first line to its last, {t_cold:.1f} s until it was read); warm process kernel "
        f"{c2['kernel']} s, native {c2['native']} s ({c2['process']:.1f} s, {t_warm:.1f} s with "
        f"its start); {sorted(os.listdir(cache_dir))}")
    if not (c1["kernel"] > 0 and c1["native"] > 0 and c2["kernel"] == 0 and c2["native"] == 0):
        failures.append(f"(c) build seconds cold {c1}, warm {c2}")

    # (d) the native loader against the numpy one, on the production GGUF
    t_d = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"(d) the native library is unavailable: {native.build_error}")
    times, trees = {}, {}
    for use_native in (True, False, True, False, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, trees[use_native] = load_params(model, device="cuda", use_native=use_native)
        torch.cuda.synchronize()
        times.setdefault(use_native, []).append(time.perf_counter() - t0)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(trees[True]),
                                                 tree_leaves(trees[False])))
    server = TTSServer(trees[True], cfg, port=0, warmup=False, allow_reload=True)
    server.start()
    reloads = {}
    original = params_mod.load_params
    try:
        client = TTSClient(*server.address)
        for use_native in (True, False, True, False, True, False):
            params_mod.load_params = functools.partial(original, use_native=use_native)
            t0 = time.perf_counter()
            answer = client.reload(model)
            reloads.setdefault(use_native, []).append(time.perf_counter() - t0)
            if answer.get("status") != "reloaded":
                raise RuntimeError(f"(d) /reload: {answer}")
    finally:
        params_mod.load_params = original
        server.shutdown()
    del trees
    med = {k: statistics.median(v) for k, v in times.items()}
    rmed = {k: statistics.median(v) for k, v in reloads.items()}
    log(f"  (d) load_params of the {os.path.getsize(model) / 1e6:.1f} MB GGUF onto the card, "
        f"median of 3: native {med[True]:.3f} s, numpy {med[False]:.3f} s (x{med[False] / med[True]:.2f}); "
        f"/reload native {rmed[True]:.3f} s, numpy {rmed[False]:.3f} s; parameters bitwise "
        f"equal: {same} [{card}]; (d) {time.perf_counter() - t_d:.1f} s")
    if not same:
        failures.append("(d) native and numpy loads differ")
    if failures:
        raise RuntimeError("phase 10: " + "; ".join(failures))
    log(f"phase 10 (training on a mesh) {time.perf_counter() - t_phase:.1f} s [{card}]")
    return served


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
    from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
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
    records, packs, held, shapes = check_stages(cfg, params, gen, pk, extra=phase9_shapes(cfg))
    records16, _, _, shapes16 = check_stages(cfg, params16, gen, pk)
    records.update(records16)
    shapes |= shapes16
    if MULTI_DEVICE_ONLY in sys.argv[1:]:
        seen = record_launch_shapes()
        with tempfile.TemporaryDirectory() as tmp:
            tiny_model = os.path.join(tmp, "tiny.gguf")
            save_params(tiny_model, init_params(TINY_CONFIG, seed=0, device="cuda"), TINY_CONFIG)
            log(f"phase 9 alone ({MULTI_DEVICE_ONLY}), {torch.cuda.device_count()} card(s)")
            multi_device_path(cfg, params, params16, tiny_model, seen, shapes)
            model = os.path.join(tmp, "model.gguf")
            save_params(model, params, cfg)
            log(f"phase 10 ({MULTI_DEVICE_ONLY}): training on a mesh")
            mesh_training_path(cfg, params, model, tmp, card, seen, shapes)
        log(f"{MULTI_DEVICE_ONLY}: phases 1-3, 9 and 10 passed in "
            f"{time.perf_counter() - t_start:.1f} s; no result line (phases 4-8 did not run)")
        return 0
    time_variants(cfg, params, gen, packs)
    seen = record_launch_shapes()

    launches = {}
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "model.gguf")
        t0 = time.perf_counter()
        save_params(model, params, cfg)
        log(f"wrote {model} ({os.path.getsize(model) / 1e6:.1f} MB, "
            f"{time.perf_counter() - t0:.1f} s)")
        # /reload's checkpoints: other weights of this geometry, and another geometry
        other_model = os.path.join(tmp, "other.gguf")
        save_params(other_model, init_params(cfg, seed=1, device="cuda"), cfg)
        tiny_model = os.path.join(tmp, "tiny.gguf")
        save_params(tiny_model, init_params(TINY_CONFIG, seed=0, device="cuda"), TINY_CONFIG)
        models = (model, other_model, tiny_model)
        for precision, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            counts, walls[precision], engine = main_path(cfg, params, model, tmp, precision)
            compare_pipelines(engine)
            streamed = stream_path(cfg, params, model, tmp, engine, held)
            engine_remainder(cfg, engine)
            served = daemon_path(cfg, params, engine, models, tmp, precision,
                                 subprocess_too=precision == "bfloat16")
            launches["mrf_stage" + suffix] = counts["mrf_stage"] + streamed + served
            launches["mrf_stage_unfolded" + suffix] = counts["mrf_stage_unfolded"]
            log(f"{precision} launches: main path {counts}, streams {streamed}, daemon phase "
                f"(daemons and reference engines) {served}")
            hold_launched_shapes(seen, shapes, f"{precision} phases 4-7")
        log("phase 8: training on the card, float32")
        launches["mrf_stage"] += training_path(cfg, params, tmp, card, seen, shapes)
        log("phase 9: multi-device serving on meshes of the card repeated")
        f32, bf16 = multi_device_path(cfg, params, params16, tiny_model, seen, shapes)
        launches["mrf_stage"] += f32
        launches["mrf_stage_bf16"] += bf16
        log("phase 10: training on a mesh of the card repeated (distinct cards where there "
            "are four)")
        launches["mrf_stage"] += mesh_training_path(cfg, params, model, tmp, card, seen, shapes)

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
        "main path (CLI, engine requests), its streams and its daemon phase (the daemons and "
        "the engines they are held against), each counted from 0, for float32 those of "
        "phase 8's engine on the trained export, those of phase 9's regimes (each counted "
        "from 0 just before its timed run and read just after; the daemons' with their warm-ups) "
        "and those of phase 10's engine on the export of the two-process training run")
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
