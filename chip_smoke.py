#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (zerovox_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the MRF-stage kernel from csrc/ with nvcc (timed, ptxas report);
  3. hold the kernel against its plain PyTorch version (mrf_stage_ref) on
     the four production MRF stages (the options vocode gives them; B=1 at
     full length, and B=8 at the engine's bucket-256 shapes) and the
     mrf_stage_unfolded entry, TF32 off, at three shapes (B=1 full length,
     B=1 and B=8 at bucket 256); time every launch with CUDA events next to
     the plain version and both bounds (f32 FMA and 3xTF32 tensor cores);
     print each launch's cluster geometry; time variants of the geometry
     (longest tile, half and twice the weight chunk, rings of 2 and 4)
     against the plan, in turns;
  4. drive the main path at the production config (ZeroVoxConfig()
     defaults, random weights from seed 0): save a GGUF with the port's
     save_params, run the CLI on it, then a TTSEngine answering two B=1
     requests and one bucket-packed batch of mixed lengths; check the
     waveforms and that every vocode went through the kernel (launch
     counts); time B=1 and B=8 synthesis; compare the kernel pipeline
     with the plain one (synthesize at B=1, synthesize_packed at B=8);
  5. print the kernels line, then the card line, then {"ok": true, ...}.
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
# (f32 non-tensor FLOP/s, TF32 tensor-core FLOP/s, HBM bytes/s).  Rates at
# the full power limit; the card's own limit is printed beside every number.
PEAKS = {"H100 PCIe": (51.2e12, 378e12, 2.0e12), "H100": (66.9e12, 495e12, 3.35e12)}
STAGE_TOL = 1e-4          # kernel vs plain: atol STAGE_TOL * max|out|
PIPELINE_WAV_ATOL = 2e-3  # kernel pipeline vs plain pipeline


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
    upsample's MACs, each input/weight read once and the output written once."""
    B, L_pre, Cin = x.shape
    flops = 2 * B * (n_convs * kr * C * C * L_out + (K_up * Cin * C * L_pre if K_up else 0))
    nbytes = 4 * (x.numel() + B * L_out * C + weights_numel)
    return flops, nbytes


def bounds_of(x, got, blocks, kw, C, K_up, n_convs, kr, pk):
    """(FLOPs, bytes, f32-FMA bound ms, 3xTF32 bound ms) of one stage call on
    these inputs: max(FLOPs / f32 rate, bytes / HBM rate), and
    max(3 FLOPs / TF32 rate, bytes / HBM rate) for f32-accurate work done as
    three TF32 products per product."""
    f32, tf32, bw = pk
    w_numel = sum(c[k].numel() for b in blocks for cs in ("convs1", "convs2")
                  for c in b[cs] for k in ("w", "b"))
    if kw:
        w_numel += kw["upsample"]["w"].numel() + kw["in_bias"].numel()
    flops, nbytes = stage_work(x, C, got.shape[1], K_up, n_convs, kr, w_numel)
    return (flops, nbytes, 1e3 * max(flops / f32, nbytes / bw),
            1e3 * max(3 * flops / tf32, nbytes / bw))


def stage_calls(cfg, params, gen, B, L0):
    """(name, stage index, x, blocks, kwargs, C, K_up) for every vocoder stage
    as vocode calls it on a B x L0-frame mel, with random stage inputs whose
    batch rows differ."""
    import torch
    voc = params["vocoder"]
    L_pre, c_pre = L0, cfg.hifigan_channels
    calls = []
    for i, s in enumerate(cfg.upsample_scales):
        up = voc["upsamples"][i]
        blocks = [voc["blocks"][i * cfg.num_resblocks + j]
                  for j in range(cfg.num_resblocks)]
        C = up["w"].shape[0]
        x = torch.randn(B, L_pre, c_pre, generator=gen, device="cuda")
        kw = dict(upsample=dict(w=up["w"], stride=s, padding=s // 2 + s % 2,
                                output_padding=s % 2),
                  in_bias=up["b"], in_leaky=0.1 if i == 0 else None,
                  out_leaky=0.01 if i == len(cfg.upsample_scales) - 1 else 0.1)
        calls.append(("mrf_stage", i, x, blocks, kw, C, up["w"].shape[2]))
        L_pre = L_pre * s
        c_pre = C
    return calls


def check_one(ms, name, i, x, blocks, kw, cfg, packed):
    """Kernel vs plain on one call; returns (kernel output, max|d|, max|ref|)."""
    import torch
    fn = getattr(ms, name)
    dils, kr = cfg.resblock_dilations, cfg.resblock_kernel_size
    got = fn(x, blocks, dils, kr, packed=packed, **kw)
    ref = ms.mrf_stage_ref(x, blocks, dils, kr, **kw)
    torch.cuda.synchronize()
    what = f"{name} stage {i + 1} B={x.shape[0]}"
    if got.shape != ref.shape:
        raise RuntimeError(f"{what}: shape {tuple(got.shape)} vs plain {tuple(ref.shape)}")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not torch.isfinite(got).all() or err > STAGE_TOL * scale:
        raise RuntimeError(f"{what}: max|d| {err:.3e} > {STAGE_TOL} * max|out| ({scale:.3e})")
    return got, err, scale


def launch_plan(ms, cfg, x, C, K_up, kw, L_out, **change):
    """The geometry mrf_stage launches this call with (`change`: another
    chunk or ring depth, for a variant)."""
    up = kw.get("upsample")
    return ms.stage_plan(x.device, C, cfg.resblock_dilations, cfg.resblock_kernel_size,
                         x.shape[0], L_out, x.shape[2] if up else 0, K_up,
                         up["stride"] if up else 1, **change)


def check_stages(cfg, params, gen, pk):
    """Kernel vs plain on the production stages at three shapes; returns
    per-entry records for the kernels line (times and bounds of the B=1
    full-length shape, the largest error of all shapes).

    B=1 at the full max_seq_len (the --no-trim / longest-bucket shape), B=1
    at bucket 256 (the serving shape of a 3 s utterance) and B=8 at bucket
    256 (the engine's packed batch; every CTA's batch-row offset is
    checked).  Each launch runs on weights packed beforehand, as the engine
    packs them."""
    import torch
    from zerovox_tpu_torch.models.hifigan import pack_vocoder
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms

    kr = cfg.resblock_kernel_size
    dils = cfg.resblock_dilations
    n_rb = len(dils)
    n_convs = sum(2 * len(d) for d in dils)
    packs = pack_vocoder(params, cfg)
    records = {}
    for shape, B, L0 in (("B=1 full", 1, cfg.max_seq_len), ("B=1 bucket 256", 1, 256),
                         ("B=8 bucket 256", 8, 256)):
        stages = stage_calls(cfg, params, gen, B, L0)
        if shape == "B=1 full":
            # the unfolded entry (every option off) on stage 2's geometry
            _, _, x2, blocks2, _, C2, _ = stages[1]
            xu = torch.randn(1, x2.shape[1] * cfg.upsample_scales[1], C2, generator=gen,
                             device="cuda")
            stages.append(("mrf_stage_unfolded", 1, xu, blocks2, {}, C2, 0))
            unfolded_pack = ms.pack_stage(blocks2, dils, kr)
        tot = dict(ms=0.0, plain=0.0, fma=0.0, tc=0.0)
        for name, i, x, blocks, kw, C, K_up in stages:
            fn = getattr(ms, name)
            pkd = packs[i] if name == "mrf_stage" else unfolded_pack
            got, err, scale = check_one(ms, name, i, x, blocks, kw, cfg, pkd)
            plan = launch_plan(ms, cfg, x, C, K_up, kw, got.shape[1])
            ms_k = cuda_ms(lambda: fn(x, blocks, dils, kr, packed=pkd, **kw), reps=5)
            ms_p = cuda_ms(lambda: ms.mrf_stage_ref(x, blocks, dils, kr, **kw), reps=3)
            flops, nbytes, b_fma, b_tc = bounds_of(x, got, blocks, kw, C, K_up, n_convs, kr,
                                                   pk)
            log(f"{shape} {name} stage {i + 1}: in {tuple(x.shape)} -> out "
                f"{tuple(got.shape)}  max|d| {err:.3e} (tol {STAGE_TOL * scale:.3e})  "
                f"kernel {ms_k:.3f} ms ({flops / ms_k / 1e9:.2f} TFLOP/s)  plain {ms_p:.3f} ms  "
                f"bound f32-FMA {b_fma:.3f} ms, 3xTF32 {b_tc:.3f} ms "
                f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
            log(f"    launch: {plan.clusters} clusters of ({n_rb},1,1) = "
                f"{plan.clusters * n_rb} CTAs x 256 threads, tile {plan.tile} rows "
                f"(window {plan.tile + 2 * ms.stage_halo(dils, kr)}), chunk {plan.kc} ch, "
                f"warp tile {plan.mt}x m16 by {plan.nt}x n8, {plan.smem} B shared; "
                f"wave {ms.wave_clusters(x.device.index or 0, n_rb, plan.nt, plan.mt)} "
                f"clusters")
            if name == "mrf_stage":
                for k, v in (("ms", ms_k), ("plain", ms_p), ("fma", b_fma), ("tc", b_tc)):
                    tot[k] += v
            if shape == "B=1 full":
                r = records.setdefault(name, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                                  fma_bound_ms=0.0, max_abs_err=0.0,
                                                  bound_by="operations"))
                r["ms"] += ms_k
                r["plain_ms"] += ms_p
                r["bound_ms"] += b_tc
                r["fma_bound_ms"] += b_fma
                if nbytes / pk[2] > 3 * flops / pk[1]:
                    r["bound_by"] = "bytes"
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        log(f"{shape}, four mrf_stage launches: kernel {tot['ms']:.3f} ms, plain "
            f"{tot['plain']:.3f} ms, bound f32-FMA {tot['fma']:.3f} ms "
            f"({100 * tot['fma'] / tot['ms']:.0f} %), 3xTF32 {tot['tc']:.3f} ms "
            f"({100 * tot['tc'] / tot['ms']:.0f} %)")
    return records, packs


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


def main_path(cfg, params, tmp):
    """CLI + engine requests; returns (launch counts, wall times, engine)."""
    import numpy as np
    import torch
    from zerovox_tpu_torch import cli
    from zerovox_tpu_torch.io.wav import read_wav
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    from zerovox_tpu_torch.params import save_params
    from zerovox_tpu_torch.runtime.engine import TTSEngine

    model = os.path.join(tmp, "model.gguf")
    t0 = time.perf_counter()
    save_params(model, params, cfg)
    log(f"wrote {model} ({os.path.getsize(model) / 1e6:.1f} MB, "
        f"{time.perf_counter() - t0:.1f} s)")
    n_stages = len(cfg.upsample_scales)

    ms.mrf_stage.launches = ms.mrf_stage_unfolded.launches = 0
    wav_path = os.path.join(tmp, "out.wav")
    t0 = time.perf_counter()
    rc = cli.main(["--model", model, "--demo", "--output", wav_path])
    log(f"cli.main: rc {rc}, {time.perf_counter() - t0:.2f} s incl. load")
    wav, sr = read_wav(wav_path)
    if rc != 0 or sr != cfg.sampling_rate or len(wav) == 0 or not np.isfinite(wav).all():
        raise RuntimeError(f"cli produced rc={rc}, {len(wav)} samples at {sr} Hz")
    expected = n_stages                          # one B=1 vocode dispatch

    engine = TTSEngine(params, cfg)
    for seed in (1, 2):                          # two B=1 requests
        src, pun, style, lens = mixed_batch(cfg, 1, seed)
        wavs, mel_len = engine.synthesize(src, pun, style, lens)
        check_wavs(wavs, mel_len, cfg.hop_size, f"B=1 request {seed}")
        expected += n_stages
        log(f"B=1 request {seed}: mel_len {int(mel_len[0])}, "
            f"bucket {engine.pick_bucket(int(mel_len[0]))}")
    src, pun, style, lens = mixed_batch(cfg, 8, 3)
    wavs, mel_len = engine.synthesize_packed(src, pun, style, lens)
    check_wavs(wavs, mel_len, cfg.hop_size, "packed batch")
    groups = engine.group_by_bucket(mel_len)
    expected += n_stages * sum(len(list(engine._ladder_chunks(g)))
                               for g in groups.values())
    log(f"packed batch of 8: mel_len {mel_len.tolist()}, "
        f"groups {{{', '.join(f'{b}: {len(g)}' for b, g in groups.items())}}}")
    counts = {"mrf_stage": ms.mrf_stage.launches,
              "mrf_stage_unfolded": ms.mrf_stage_unfolded.launches}
    log(f"launches on the main path: {counts} (expected mrf_stage {expected})")
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
        log(f"engine.synthesize B={B}: wall {walls[B]:.2f} ms "
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
        log(f"  B={B} split: front {statistics.median(fronts):.2f} ms, vocoder at "
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


def compare_pipelines(cfg, params, engine):
    """The kernel path vs the plain path on the same inputs: synthesize() at
    B=1, and the engine's packed batch of 8 mixed lengths."""
    import numpy as np
    from zerovox_tpu_torch.models.pipeline import synthesize
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
    err = (got.wav - ref.wav).abs().max().item()
    err8 = max(float(np.abs(a - b).max()) for a, b in zip(wavs, ref_wavs))
    log(f"pipeline kernel vs plain: synthesize B=1 wav max|d| {err:.3e}, mel_len "
        f"{int(got.mel_len[0])}; synthesize_packed B=8 wav max|d| {err8:.3e}, "
        f"mel_len {mel_len.tolist()} (atol {PIPELINE_WAV_ATOL})")
    if not max(err, err8) <= PIPELINE_WAV_ATOL:
        raise RuntimeError(f"pipeline wav max|d| {max(err, err8):.3e} > {PIPELINE_WAV_ATOL}")
    return max(err, err8)


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
    from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
    from zerovox_tpu_torch.params import init_params

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    pk = peaks(name)
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"bounds from {pk[0] / 1e12:.1f} TFLOP/s f32, {pk[1] / 1e12:.0f} TFLOP/s TF32, "
        f"{pk[2] / 1e12:.2f} TB/s")

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
    log(f"production params (seed 0) on the card in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    records, packs = check_stages(cfg, params, gen, pk)
    time_variants(cfg, params, gen, packs)

    with tempfile.TemporaryDirectory() as tmp:
        counts, walls, engine = main_path(cfg, params, tmp)
    compare_pipelines(cfg, params, engine)

    replaces = {"mrf_stage": "zerovox_tpu/ops/pallas/folded_mrf.py:446",
                "mrf_stage_unfolded": "zerovox_tpu/ops/pallas/folded_mrf.py:720"}
    kernels = [{
        "name": k, "route": "cuda", "source": "zerovox_tpu_torch/csrc/mrf_stage.cu",
        "replaces": replaces[k], "launches": counts[k],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
    } for k, r in records.items()]
    log("kernels line: ms, plain_ms and bound_ms are the sums over the four B=1 "
        "full-length stages (the unfolded entry: its one call); bound_ms is the "
        "3xTF32 tensor-core bound, max(3 FLOPs / TF32 rate, bytes / HBM rate)")
    log(f"e2e: B=1 wall {walls[1]:.2f} ms, B=8 wall {walls[8]:.2f} ms; "
        f"smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
