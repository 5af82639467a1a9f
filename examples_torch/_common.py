"""Shared example plumbing: device, config and parameter selection.

Every example calls `setup(argv)` first.  The examples run on the card by
default; `--device cpu` runs them on the CPU at TINY_CONFIG.  Without a
card and without `--device cpu` setup raises, as every entry point of
zerovox_tpu_torch does: nothing falls back to the CPU."""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup(argv=None):
    """Parse the common flags and resolve the device; return (args, cfg,
    params).

    --device cuda (default): the card, production geometry (ZeroVoxConfig()
      defaults) with random weights.
    --device cpu: the CPU, TINY_CONFIG with random weights (the fast path
      tests/test_torch_examples.py runs).
    --model: load a GGUF checkpoint (its own geometry) onto the device.
    Random weights are init_params(cfg, seed=0), the same values as the
    JAX package's init_params with that seed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (cpu: TINY config, a fast demo)")
    ap.add_argument("--model", default=None, help="GGUF checkpoint path")
    ap.add_argument("--out-dir", default=tempfile.gettempdir(),
                    help="output directory")
    args = ap.parse_args(argv)

    from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
    from zerovox_tpu_torch.device import resolve_device
    from zerovox_tpu_torch.params import init_params, load_params
    args.device = resolve_device(args.device)
    if args.model:
        cfg, params = load_params(args.model, device=args.device)
    else:
        cfg = TINY_CONFIG if args.device.type == "cpu" else ZeroVoxConfig()
        params = init_params(cfg, seed=0, device=args.device)
    return args, cfg, params


def demo_utterance(cfg, seed: int = 0, batch: int = 1):
    """A reproducible random utterance (ids + style vector): the JAX
    examples' demo_utterance, draw for draw."""
    import numpy as np
    rng = np.random.default_rng(seed)
    src = rng.integers(1, cfg.num_phonemes + 1,
                       size=(batch, cfg.max_n_phonemes)).astype(np.int32)
    pun = rng.integers(0, cfg.num_puncts + 1,
                       size=(batch, cfg.max_n_phonemes)).astype(np.int32)
    style = rng.normal(scale=0.1, size=(batch, cfg.d_model)).astype(np.float32)
    return src, pun, style
