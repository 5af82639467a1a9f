"""What limits the MRF-stage kernel: time it beside copies of its source
with one part of the work taken out, on the production stages.

    python -m zerovox_tpu_torch.tools.mrf_ablation [--shape full|bucket256]
                                                   [--dtype float32|bfloat16|f16-staged]

Each ablation is a text substitution in the mode's source (float32:
csrc/mrf_stage.cu; bfloat16 and f16-staged: csrc/mrf_stage_bf16.cu, the
latter built with its define and run on float32 tensors under
ops.conv.f16_staging), built with the kernel's own nvcc flags into
build/zerovox_tpu_torch/ablation/ (all builds at once).  An ablated kernel computes a wrong result: only its time means
something.  The difference to the kernel's time is what that part costs.
float32 (3xTF32 mma.sync):
  one product     hi*hi only, not hi*hi + hi*lo + lo*hi (1/3 of the MMAs)
  no split        operands fed to the MMA unsplit, one product
  no weight copy  the weight ring's chunks are never copied (the stream's cost)
  no upsample     the fused ConvTranspose1d prologue skips its arithmetic
  no chain        the convs' k-steps (fragment loads, splits, MMAs) are skipped:
                  what remains is the work around the chain
bfloat16 and f16-staged (wgmma, bulk-copied weight chunks, the upsample on
the tensor cores; the same sites in both):
  no chain        the convs' wgmmas are skipped (their chunks still stream,
                  the epilogues still run): the work around the chain
  no upsample     the upsample's wgmmas are skipped (its chunks still stream)
  no epilogue     the convs' epilogues (bias, residual, leaky, rounding,
                  the operand planes) are skipped
  no overlap      each chunk is released once its products are done and the
                  next is copied only then: no copy runs beside the products
  no weight copy  no chunk is copied (each slot's barrier completes at once)
  own h only      the upsample's rows go to this CTA's h window only, not to the
                  cluster's others through distributed shared memory
Every variant runs in turns (kernel, ablations, ablations reversed,
kernel), median of 5 CUDA-event timings each, on one card.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import torch

from ..config import ZeroVoxConfig
from ..models.hifigan import pack_vocoder
from ..models.pipeline import cast_params
from ..ops.conv import f16_staging
from ..ops.cuda import mrf_stage as ms
from ..params import init_params
from ..utils.compile_cache import build_dir

_MMA3 = """          mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
          mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
          mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);"""
_MMA1 = """          mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);"""
_SPLIT = """  hi = rna_tf32(v);
  lo = rna_tf32(v - __uint_as_float(hi));"""
_NO_SPLIT = """  hi = __float_as_uint(v);
  lo = 0u;"""
_COPY = """  mbar_expect_tx(sm.full + s, (uint32_t)(p.kc * C * 4));
  bulk_copy(sm.ring + (size_t)s * p.kc * C, src, (uint32_t)(p.kc * C * 4), sm.full + s);"""
_NO_COPY = """  (void)src;
  mbar_expect_tx(sm.full + s, 0u);"""
_UPSAMPLE = "for (int k = k0; k < p.K_up; k += s) {"
_NO_UPSAMPLE = "for (int k = k0; k < 0; k += s) {"
_CHAIN = "for (int kk = 0; kk < KC; kk += 8) {"
_NO_CHAIN = "for (int kk = 0; kk < 0; kk += 8) {"

# the bf16 source's sites
_B_CHAIN = "  gemm<C, KB, MT>(p, sm, st, rank, lag, acc, (p.window + 63) / 64,"
_B_NO_CHAIN = "  gemm<C, KB, MT, false>(p, sm, st, rank, lag, acc, (p.window + 63) / 64,"
_B_UP = "    gemm<C, KB, MT>(p, sm, st, rank, lag, acc, max(1, (n_ph + 63) / 64),"
_B_NO_UP = "    gemm<C, KB, MT, false>(p, sm, st, rank, lag, acc, max(1, (n_ph + 63) / 64),"
_B_EPI = "    if (!act[i]) continue;                           // the same for the warpgroup"
_B_NO_EPI = "    if (act[i] || !act[i]) continue;"
_B_LAG = "  const int lag = p.stages;                           // chunks the ring runs ahead"
_B_NO_LAG = "  const int lag = 1;"
_B_RELEASE = """    wg_wait<1>();
    if (c > 0) release<C, KB, MT>(p, sm, st, rank, q - 1, lag);"""
_B_RELEASE_NOW = """    wg_wait<0>();
    release<C, KB, MT>(p, sm, st, rank, q, lag);"""
_B_LAST = "  if (n_chunks > 0) release<C, KB, MT>(p, sm, st, rank, q - 1, lag);"
_B_NO_LAST = "  // every chunk released in the loop"
_B_COPY = """  mbar_expect_tx(sm.full + s, (uint32_t)G::CHUNK);
  bulk_copy(dst, chunk_src<C, KB, MT>(p, st, rb, n), (uint32_t)G::CHUNK, sm.full + s);"""
_B_NO_COPY = """  (void)dst;
  mbar_expect_tx(sm.full + s, 0u);"""
_B_REMOTE = "            if (rr < p.n_rb) st_cluster_f2(hs[rr] + off, v);"
_B_LOCAL = "            if (rr == rank) st_cluster_f2(hs[rr] + off, v);"

ABLATIONS = {
    "float32": {
        "one product": [(_MMA3, _MMA1)],
        "no split": [(_MMA3, _MMA1), (_SPLIT, _NO_SPLIT)],
        "no weight copy": [(_COPY, _NO_COPY)],
        "no upsample": [(_UPSAMPLE, _NO_UPSAMPLE)],
        "no chain": [(_CHAIN, _NO_CHAIN)],
    },
    "bfloat16": {
        "no chain": [(_B_CHAIN, _B_NO_CHAIN)],
        "no upsample": [(_B_UP, _B_NO_UP)],
        "no epilogue": [(_B_EPI, _B_NO_EPI)],
        "no overlap": [(_B_LAG, _B_NO_LAG), (_B_RELEASE, _B_RELEASE_NOW), (_B_LAST, _B_NO_LAST)],
        "no weight copy": [(_B_COPY, _B_NO_COPY)],
        "own h only": [(_B_REMOTE, _B_LOCAL)],
    },
}
ABLATIONS["f16-staged"] = ABLATIONS["bfloat16"]


def build_all(names, mode):
    """{name: ms.Library whose entry of `mode` (--dtype's name) is the
    ablated build} for the kernel and each ablation, nvcc runs in
    parallel."""
    tag = _TAGS[mode]
    source, defines, entry_name = next((m[1], m[2], m[3]) for m in ms._MODES if m[0] == tag)
    ablations = ABLATIONS[mode]
    src = source.read_text()
    out = build_dir() / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in ablations.get(name, []):
            if old not in text:
                raise RuntimeError(f"ablation {name!r}: pattern not in {source}")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        (out / f"{stem}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [ms._nvcc(), *ms.NVCC_FLAGS, *defines,
             "-o", str(out / f"{stem}_{tag}.so"), str(out / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    proto = ms.library()
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on ablation {name!r}:\n{log}")
        entry = getattr(ctypes.CDLL(str(out / f"{name.replace(' ', '_')}_{tag}.so")), entry_name)
        entry.argtypes = proto.stage[tag].argtypes
        entry.restype = proto.stage[tag].restype
        libs[name] = proto._replace(stage={**proto.stage, tag: entry})
    return libs


# --dtype -> the kernel mode (ms.kernel_mode) it times
_TAGS = {"float32": "f32", "bfloat16": "bf16", "f16-staged": "f16_staged"}


def cuda_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=("full", "bucket256"), default="full")
    ap.add_argument("--dtype", choices=tuple(_TAGS), default="float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mrf_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    staged = args.dtype == "f16-staged"
    dtype = torch.float32 if staged else getattr(torch, args.dtype)
    names = ["kernel", *ABLATIONS[args.dtype]]
    libs = build_all(names, args.dtype)
    with f16_staging(staged):
        return _time(args, dtype, names, libs)


def _time(args, dtype, names, libs) -> int:
    """Every variant's time per production stage, in the calling context's
    mode (under f16_staging: the f16-staged one)."""
    cfg = ZeroVoxConfig()
    params = cast_params(init_params(cfg, seed=0, device="cuda"), dtype)
    packs = pack_vocoder(params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    voc, dils, kr = params["vocoder"], cfg.resblock_dilations, cfg.resblock_kernels
    L_pre, c_pre = (cfg.max_seq_len if args.shape == "full" else 256), cfg.hifigan_channels
    print(f"card: {torch.cuda.get_device_name(0)}; {args.dtype}, shape B=1, {L_pre} mel frames",
          flush=True)
    real = ms.library
    try:
        for i, s in enumerate(cfg.upsample_scales):
            up = voc["upsamples"][i]
            blocks = [voc["blocks"][i * cfg.num_resblocks + j] for j in range(cfg.num_resblocks)]
            x = torch.randn(1, L_pre, c_pre, generator=gen, device="cuda").to(dtype)
            kw = dict(upsample=dict(w=up["w"], stride=s, padding=s // 2 + s % 2,
                                    output_padding=s % 2),
                      in_bias=up["b"], in_leaky=0.1 if i == 0 else None,
                      out_leaky=0.01 if i == len(cfg.upsample_scales) - 1 else 0.1)
            times = {n: [] for n in names}
            for name in names:              # a fault names its variant before the run dies
                print(f"  stage {i + 1}: {name}", flush=True)
                ms.library = lambda lib=libs[name]: lib
                ms.mrf_stage(x, blocks, dils, kr, packed=packs[i], **kw)
                torch.cuda.synchronize()
            for name in names + names[::-1]:
                ms.library = lambda lib=libs[name]: lib
                times[name].append(cuda_ms(
                    lambda: ms.mrf_stage(x, blocks, dils, kr, packed=packs[i], **kw)))
            ms.library = real
            base = statistics.mean(times["kernel"])
            print(f"stage {i + 1} (C={up['w'].shape[0]}): " + ", ".join(
                f"{n} {' / '.join('%.3f' % t for t in v)} ms"
                + ("" if n == "kernel" else f" ({statistics.mean(v) - base:+.3f})")
                for n, v in times.items()), flush=True)
            L_pre, c_pre = L_pre * s, up["w"].shape[0]
    finally:
        ms.library = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
