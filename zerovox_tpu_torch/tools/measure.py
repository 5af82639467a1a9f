"""What the measurement tools share.

The tools are the port's counterparts of the JAX package's measurement
scripts, each a `python -m zerovox_tpu_torch.tools.<name>` program:

    bench                  the root bench.py: RTF, B=8, TTFA, the daemon leg
    bench_daemon           scripts/bench_daemon.py: the daemon over a socket
    measure_daemon_attrib  scripts/measure_daemon_attrib.py: where its p50 goes
    profile_trace          scripts/profile_trace.py: the card's events by name
    profile_mel            scripts/profile_mel.py: the front by segment
    profile_breakdown      scripts/profile_breakdown.py: the pipeline by segment

Each prints the lines and JSON keys its JAX counterpart prints.  Each runs
on the card (`--device cuda`, the default) and raises without one, unless
`--device cpu` asks for the CPU; `--tiny` takes TINY_CONFIG's geometry.
Each builds the MRF kernel into the port's build directory, or into
$ZV_COMPILE_CACHE where that is set, so that tools run one after another
build it once.  Each reports on standard error the MRF kernel's launches
in its own process, as one line "<tool>: mrf_launches {"<kernel>": N}".
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import TINY_CONFIG, ZeroVoxConfig
from ..device import resolve_device

ROOT = Path(__file__).resolve().parents[2]      # the checkout: `python -m` runs from here


def add_device_flags(ap):
    """--device (default cuda) and --tiny."""
    ap.add_argument("--device", default="cuda",
                    help="where to run (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--tiny", action="store_true", help="TINY_CONFIG geometry")


def start(device) -> torch.device:
    """The resolved device (raising where it names CUDA and there is no card),
    with $ZV_COMPILE_CACHE as the build directory where it is set."""
    dev = resolve_device(device)
    cache = os.environ.get("ZV_COMPILE_CACHE")
    if cache:
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache(cache)
    return dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them ("cpu" on
    the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def model_config(tiny: bool, precision: str) -> ZeroVoxConfig:
    """The production geometry (or TINY) in `precision`."""
    return (TINY_CONFIG if tiny else ZeroVoxConfig()).replace(compute_dtype=precision)


def draw_inputs(cfg: ZeroVoxConfig, B: int, rng: np.random.Generator):
    """A (src, puncts, style) batch drawn as bench.py draws its inputs:
    ids in [0, num_phonemes] and [0, num_puncts], style N(0, 0.1)."""
    src = rng.integers(0, cfg.num_phonemes + 1, size=(B, cfg.max_n_phonemes)).astype(np.int32)
    pun = rng.integers(0, cfg.num_puncts + 1, size=(B, cfg.max_n_phonemes)).astype(np.int32)
    style = rng.normal(scale=0.1, size=(B, cfg.d_model)).astype(np.float32)
    return src, pun, style


def on_device(dev: torch.device, src, pun, style):
    """The arrays as the pipeline takes them on `dev`: int64 ids, float32 style."""
    return (torch.as_tensor(src, device=dev).long(), torch.as_tensor(pun, device=dev).long(),
            torch.as_tensor(style, device=dev))


def shift_duration(params: dict, shift: float = 1.5) -> dict:
    """params with the duration predictor's output bias raised by `shift`:
    random weights then predict utterances of production-like length."""
    dp = dict(params["encoder"]["duration_predictor"])
    dp["lin_b"] = dp["lin_b"] + shift
    return dict(params, encoder=dict(params["encoder"], duration_predictor=dp))


def kernel_name(precision: str) -> str:
    """The kernels line's name of the MRF kernel's mode for `precision`."""
    return {"float32": "mrf_stage", "bfloat16": "mrf_stage_bf16"}[precision]


def report_launches(tool: str, precision: str):
    """Print this process's MRF kernel launches on standard error."""
    from ..ops.cuda import mrf_stage as ms
    print(f"{tool}: mrf_launches "
          f"{json.dumps({kernel_name(precision): ms.mrf_stage.launches})}",
          file=sys.stderr, flush=True)
