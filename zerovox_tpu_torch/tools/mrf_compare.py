"""Time the MRF kernel of two checkouts on one card, in turns.

    python -m zerovox_tpu_torch.tools.mrf_compare --other DIR [--reps 5] [--rounds 1]
                                                  [--only TEXT]

DIR is another checkout of the repository, such as the parent commit
unpacked with `git archive` into a directory that .gitignore lists.  The
runs alternate other, this, this, other (`rounds` times over); each is a
subprocess started at the root of its checkout, which imports that
checkout's package, builds its kernels into its own build directory and
times, with CUDA events (median of `reps` after a warm-up), every stage that
chip_smoke.py's phase 3 times: the bfloat16 stages at B=1 full length, B=1
and B=8 at bucket 256 and the stream's window sizes, and the float32 and
f16-staged stages at B=1 full length (the f16-staged under
ops.conv.f16_staging), or only the shapes whose name contains `only`.
Inputs and weights come from the same seeds in every run.  It prints each
run's times per stage, then per shape the four-stage sums of both checkouts
(the mean of their runs) and their ratio, with the card's name and power
limit, and a JSON summary as its last line.  A run uses only entry points
both checkouts have (init_params, cast_params, pack_vocoder, mrf_stage,
f16_staging, chunk_plan, compile_cache.loaded).  It also compares, per
kernel mode, the machine code (cuobjdump -sass) of the library each
checkout built, the anonymous namespace's per-file names masked: 0
differing lines means the mode's kernels are the same code.  Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# What one run does, at the root of a checkout (its package first on sys.path)
_RUN = r'''
import json, statistics, sys
import torch
from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.models.hifigan import pack_vocoder
from zerovox_tpu_torch.models.pipeline import cast_params
from zerovox_tpu_torch.models.streaming import chunk_plan
from zerovox_tpu_torch.ops.conv import f16_staging
from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
from zerovox_tpu_torch.params import init_params

reps, only = int(sys.argv[1]), sys.argv[2]
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cfg = ZeroVoxConfig()
params = init_params(cfg, seed=0, device="cuda")
params16 = cast_params(params, torch.bfloat16)
dils, kr = cfg.resblock_dilations, cfg.resblock_kernel_size


def cuda_ms(fn):
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stages(p, B, L0, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    voc = p["vocoder"]
    L_pre, c_pre = L0, cfg.hifigan_channels
    out = []
    for i, s in enumerate(cfg.upsample_scales):
        up = voc["upsamples"][i]
        blocks = [voc["blocks"][i * cfg.num_resblocks + j] for j in range(cfg.num_resblocks)]
        x = torch.randn(B, L_pre, c_pre, generator=gen, device="cuda").to(up["w"].dtype)
        kw = dict(upsample=dict(w=up["w"], stride=s, padding=s // 2 + s % 2,
                                output_padding=s % 2),
                  in_bias=up["b"], in_leaky=0.1 if i == 0 else None,
                  out_leaky=0.01 if i == len(cfg.upsample_scales) - 1 else 0.1)
        out.append((x, blocks, kw))
        L_pre, c_pre = L_pre * s, up["w"].shape[0]
    return out


def time_shape(p, packs, B, L0, seed):
    return [cuda_ms(lambda: ms.mrf_stage(x, blocks, dils, kr, packed=packs[i], **kw))
            for i, (x, blocks, kw) in enumerate(stages(p, B, L0, seed))]


windows = list(dict.fromkeys(w[1] for w in chunk_plan(cfg.max_seq_len,
                                                      -(-cfg.max_seq_len // 64), 64, 16)))
shapes = [("B=1 full", 1, cfg.max_seq_len), ("B=1 bucket 256", 1, 256),
          ("B=8 bucket 256", 8, 256)] + [(f"B=1 window {w}", 1, w) for w in windows]
times = {}
with torch.no_grad():
    packs16 = pack_vocoder(params16, cfg)
    for k, (name, B, L0) in enumerate(shapes):
        if only in "bf16 " + name:
            times["bf16 " + name] = time_shape(params16, packs16, B, L0, 100 + k)
    if only in "f32 B=1 full":
        times["f32 B=1 full"] = time_shape(params, pack_vocoder(params, cfg), 1,
                                           cfg.max_seq_len, 100)
    if only in "f16-staged B=1 full":
        with f16_staging():
            times["f16-staged B=1 full"] = time_shape(params, pack_vocoder(params, cfg), 1,
                                                      cfg.max_seq_len, 100)
print("RESULT " + json.dumps(times))
from zerovox_tpu_torch.utils.compile_cache import loaded
print("LIBS " + json.dumps(loaded()))
'''


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def run_once(root: Path, reps: int, only: str):
    """One run at `root`: its times per shape, per stage (ms), and the
    libraries it loaded."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", _RUN, str(reps), only], cwd=root, env=env,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"run at {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    out = {k: json.loads(x[len(k) + 1:]) for x in proc.stdout.splitlines()
           for k in ("RESULT", "LIBS") if x.startswith(k + " ")}
    return out["RESULT"], out["LIBS"]


def cuobjdump_sass(lib: str) -> str:
    """cuobjdump -sass of a library: the machine code of its kernels."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=600).stdout


def sass(lib: str):
    """A library's machine code as lines, the per-file names of the
    anonymous namespace (which follow the file's path) masked."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "ANON",
                  cuobjdump_sass(lib)).splitlines()


def compare_sass(libs: dict) -> dict:
    """Per kernel mode (the tag in mrf_stage_<tag>_<digest>.so), the SASS
    line counts of both checkouts' builds and the lines that differ: those
    of one listing that the other lacks, both ways (every instruction line
    carries its address, so two listings with none differ are the same
    code; counted in linear time, as two unrelated listings of 10^5 lines
    would take a line diff long)."""
    def by_mode(paths):
        return {m.group(1): p for p in paths
                if (m := re.match(r"mrf_stage_(\w+)_[0-9a-f]{12}\.so$", Path(p).name))}
    other, this = by_mode(libs["other"]), by_mode(libs["this"])
    result = {}
    for mode in sorted(set(other) & set(this)):
        a, b = collections.Counter(sass(other[mode])), collections.Counter(sass(this[mode]))
        result[mode] = dict(other_lines=sum(a.values()), this_lines=sum(b.values()),
                            differing_lines=sum(((a - b) + (b - a)).values()))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1, help="other, this, this, other: times")
    ap.add_argument("--only", default="", help="only the shapes whose name contains this")
    args = ap.parse_args(argv)
    other = Path(args.other).resolve()
    if not (other / "zerovox_tpu_torch").is_dir():
        print(f"mrf_compare: no zerovox_tpu_torch package in {other}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    runs = {"other": [], "this": []}
    libs = {}
    order = (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)) * args.rounds
    for label, root in order:
        times, libs[label] = run_once(root, args.reps, args.only)
        runs[label].append(times)
        for shape, ts in times.items():
            print(f"{label} ({root.name}) {shape}: " + " / ".join(f"{t:.3f}" for t in ts)
                  + f" ms, sum {sum(ts):.3f} ms", flush=True)
    summary = {}
    for shape in runs["this"][0]:
        o = [sum(r[shape]) for r in runs["other"]]
        t = [sum(r[shape]) for r in runs["this"]]
        per_stage = {lbl: [sum(r[shape][i] for r in runs[lbl]) / len(runs[lbl])
                           for i in range(len(runs[lbl][0][shape]))] for lbl in runs}
        summary[shape] = dict(other_ms=o, this_ms=t, ratio=sum(t) / sum(o),
                              other_stage_ms=per_stage["other"], this_stage_ms=per_stage["this"])
        print(f"{shape}: other {' / '.join('%.3f' % v for v in o)} ms, this "
              f"{' / '.join('%.3f' % v for v in t)} ms, this / other "
              f"{summary[shape]['ratio']:.3f} [{card}]", flush=True)
    machine_code = compare_sass(libs)
    for mode, d in machine_code.items():
        print(f"SASS {mode}: other {d['other_lines']} lines, this {d['this_lines']} lines, "
              f"differing lines {d['differing_lines']}", flush=True)
    print(json.dumps({"card": card, "shapes": summary, "sass": machine_code}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
