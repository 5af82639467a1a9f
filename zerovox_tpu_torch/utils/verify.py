"""User-checkpoint parity verification against the reference C++ classes.

The port of zerovox_tpu/utils/verify.py.  `python -m zerovox_tpu_torch.cli
--model model.gguf --verify` compiles the reference's own FS2Encoder /
StyleTTSDecoder / HiFiGAN (unmodified, against its vendored ggml build:
refharness/), loads the user's GGUF into BOTH implementations, and diffs the
three eval() boundaries (the reference's src/fs2encoder.cpp:594,
stylettsdec.cpp:457, hifigan.cpp:358): the encoder with the length
regulator, the decoder on the reference's hidden state, the vocoder on the
reference's mel.  The probe utterance, the boundaries and their order, the
tolerances, the margin mask and the report's text are the JAX tool's.

Isolation: the reference classes run in a dedicated worker subprocess with
a zeroing allocator preloaded (refharness/stage_proc.py: they depend on
zero-born heap pages).  Our side runs the float32 parity path eagerly on
`device` (the card by default, where the vocoder's MRF stages run the
kernel's f16-staged mode; "cpu" computes what the JAX tool computes) under
ops.conv.f16_staging, the simulation of ggml's f16 conv weights and f16
im2col.  The reference's arrays go to the device as the inputs of
boundaries 2 and 3.

Per-boundary tolerances are the production-geometry differential bands of
tests/test_ggml_stage_diff_prod.py (about 5x the measured deviation).  The
encoder boundary diffs the post-length-regulator hidden state on frames
whose duration rounding has a safety margin; a checkpoint whose predicted
durations sit exactly on rounding boundaries reports those frames as
skipped rather than failing spuriously (a flip that moves mel_len still
fails the boundary: the JAX tool's verdict, kept so that both tools agree
on every input).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class BoundaryDiff:
    name: str
    max_abs: float
    tol: float
    ok: bool
    note: str = ""

    def line(self) -> str:
        status = "OK  " if self.ok else "FAIL"
        extra = f"  ({self.note})" if self.note else ""
        return (f"  [{status}] {self.name:<28} max|diff| {self.max_abs:.3e} "
                f"(tol {self.tol:.0e}){extra}")


@dataclass
class VerifyReport:
    gguf_path: str
    boundaries: List[BoundaryDiff]
    ok: bool
    skipped_reason: Optional[str] = None

    def summary(self) -> str:
        if self.skipped_reason:
            return (f"verify: SKIPPED — reference harness unavailable: "
                    f"{self.skipped_reason}")
        lines = [f"verify: {self.gguf_path} vs the compiled reference classes"]
        lines += [b.line() for b in self.boundaries]
        lines.append("verify: " + ("PASS — all eval() boundaries match"
                                   if self.ok else "FAIL"))
        return "\n".join(lines)


def probe_utterance(cfg, seed: int = 7):
    """The probe (src, puncts, style) the JAX tool draws from `seed`."""
    rng = np.random.default_rng(seed)
    P = cfg.max_n_phonemes
    src = rng.integers(1, cfg.num_phonemes, size=P).astype(np.int32)
    pun = rng.integers(0, cfg.num_puncts, size=P).astype(np.int32)
    style = rng.normal(scale=0.1, size=cfg.d_model).astype(np.float32)
    return src, pun, style


def verify_checkpoint(gguf_path: str, seed: int = 7,
                      log=lambda msg: print(msg, file=sys.stderr, flush=True),
                      device="cuda") -> VerifyReport:
    """Diff our stages on `device` against the reference classes on `gguf_path`.

    Returns a VerifyReport; `report.ok` is the gate.  Raises nothing for
    harness unavailability (report.skipped_reason instead) so the CLI can
    exit 2 (skip) vs 1 (mismatch) vs 0 (pass).  A CUDA device without a
    card raises (before the harness is looked for), as does a worker that
    fails or dies mid-run."""
    from ..device import resolve_device
    from ..refharness.build import get_stage_harness
    from .compile_cache import build_dir

    dev = resolve_device(device)
    lib, reason = get_stage_harness(build_dir() / "refharness")
    if lib is None:
        return VerifyReport(gguf_path, [], ok=False, skipped_reason=reason)

    from ..models import fs2_encoder, hifigan, styletts_decoder
    from ..ops.conv import f16_staging
    from ..ops.length_regulator import durations_from_log, length_regulate
    from ..params import load_params
    from ..refharness.stage_proc import RefStages

    t0 = time.perf_counter()
    cfg, params = load_params(gguf_path, device=dev)
    log(f"verify: loaded {gguf_path} (T={cfg.max_seq_len}, "
        f"d_model={cfg.d_model}) in {time.perf_counter()-t0:.1f}s")

    src, pun, style = probe_utterance(cfg, seed)
    P = cfg.max_n_phonemes
    style_t = torch.as_tensor(style, device=dev)[None]

    def host(t: torch.Tensor) -> np.ndarray:
        return t.to(torch.float32).cpu().numpy()

    t0 = time.perf_counter()
    ref = RefStages(lib, gguf_path, cfg)
    log(f"verify: reference stages loaded in the worker "
        f"({time.perf_counter()-t0:.1f}s)")

    diffs: List[BoundaryDiff] = []
    try:
        with torch.no_grad(), f16_staging():
            # ---- boundary 1: FS2Encoder::eval (features + host LR loop) ----
            t0 = time.perf_counter()
            ref_x, ref_len = ref.encoder(src, pun, style, P)
            feat, log_dur = fs2_encoder.encode(
                params, cfg, torch.as_tensor(src, device=dev).long()[None],
                torch.as_tensor(pun, device=dev).long()[None], style_t)
            dur = durations_from_log(log_dur, cfg.max_seq_len)
            hidden, total = length_regulate(feat, dur, cfg.max_seq_len)
            h = host(hidden[0])
            mel_len = int(total[0])

            len_ok = mel_len == ref_len
            # frames from phonemes whose duration rounding has a margin: an
            # f16-noise-flipped rounding shifts whole rows and is a fixture
            # sensitivity, not an implementation mismatch (stage-diff tests
            # assert the margin; on arbitrary user checkpoints we mask)
            d = np.exp(host(log_dur[0]).astype(np.float64)) - 1.0 + 0.5
            margin_ok = np.abs(d - np.round(d)) > 1e-3
            durs = dur[0].cpu().numpy()
            frame_phoneme = np.repeat(np.arange(P), durs)[:cfg.max_seq_len]
            clean = np.ones(cfg.max_seq_len, dtype=bool)
            clean[:len(frame_phoneme)] = margin_ok[frame_phoneme]
            n_masked = int((~clean).sum())
            if clean.any():
                err = float(np.abs(h[clean] - ref_x[clean]).max())
                tol = float(5e-4 + 1e-3 * np.abs(ref_x[clean]).max())
            else:   # every frame margin-masked: nothing comparable this seed
                err, tol = 0.0, float("inf")
            note = f"mel_len {mel_len} vs {ref_len}"
            if n_masked:
                note += (f"; {n_masked} rounding-margin frames masked — a FAIL"
                         " here can be margin-flip sensitivity, retry with a"
                         " different --verify-seed")
            diffs.append(BoundaryDiff(
                "encoder (hidden, mel_len)", err, tol,
                ok=len_ok and err <= tol, note=note))
            log(f"verify: encoder boundary done ({time.perf_counter()-t0:.1f}s)")

            # ---- boundary 2: StyleTTSDecoder::eval on the REF hidden ----
            t0 = time.perf_counter()
            ref_mel = ref.decoder(ref_x, style)
            mel = styletts_decoder.decode(
                params, cfg, torch.tensor(ref_x, device=dev)[None], style_t)
            m = host(mel[0])
            err = float(np.abs(m - ref_mel).max())
            tol = 5e-3 + 1e-3 * float(np.abs(ref_mel).max())
            diffs.append(BoundaryDiff("decoder (mel)", err, tol, err <= tol))
            log(f"verify: decoder boundary done ({time.perf_counter()-t0:.1f}s)")

            # ---- boundary 3: HiFiGAN::eval on the REF mel ----
            t0 = time.perf_counter()
            ref_wav = ref.vocoder(ref_mel)
            wav = hifigan.vocode(params, cfg, torch.tensor(ref_mel, device=dev)[None])
            w = host(wav[0])
            err = float(np.abs(w - ref_wav).max())
            tol = 2e-3 + 1e-3 * float(np.abs(ref_wav).max())
            diffs.append(BoundaryDiff("vocoder (wav)", err, tol, err <= tol))
            log(f"verify: vocoder boundary done ({time.perf_counter()-t0:.1f}s)")
    finally:
        ref.free()

    ok = all(b.ok for b in diffs)
    return VerifyReport(gguf_path, diffs, ok=ok)
