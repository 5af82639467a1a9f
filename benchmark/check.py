"""The comparison that decides `correct`.

Once the window has closed and the daemon is gone, the plain reference
(benchmark.reference.model, float32, TF32 off) computes each utterance of
the checked sample anew from the same weight arrays and utterances, and the
program's answers are held against it:

  failed          requests of the window that got no full answer (limit 0)
  length_gap      samples by which an answer's length differs from what the
                  reference's mel length makes it: mel_len * hop, and for a
                  stream whole chunks of `chunk_frames` (limit 0)
  wav_rel_rms     the worst answer's rms(program - reference) over
                  rms(reference), both PCM16
  wav_max_lsb     the worst answer's largest |program - reference|, in
                  PCM16 steps

The last two are compared where benchmark/checks/<cell>.json gives them a
limit (PERF.md gives the readings each limit was set from), and reported
beside the result otherwise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

EXACT = {"failed": 0, "length_gap": 0}


def expected_samples(mix: dict, model: dict, mel_len: int) -> int:
    """The answer's length for an utterance of mel_len frames: trimmed to
    mel_len * hop; a stream emits whole chunks (at least one) up to
    max_seq_len."""
    hop = model["hop_size"]
    if mix["endpoint"] != "/stream":
        return mel_len * hop
    ch = mix["chunk_frames"]
    n = max(1, -(-mel_len // ch))
    return min(n * ch, model["max_seq_len"]) * hop


def answer_errors(prog: np.ndarray, ref: np.ndarray) -> Tuple[float, float]:
    """(rms relative error, largest error in PCM16 steps) of an answer
    against the reference's PCM16 over the answer's length."""
    p = prog.astype(np.float64)
    r = ref[:len(prog)].astype(np.float64)
    if len(r) < len(p):
        r = np.concatenate([r, np.zeros(len(p) - len(r))])
    diff = p - r
    scale = np.sqrt(np.mean(r * r)) if len(r) else 0.0
    rel = float(np.sqrt(np.mean(diff * diff)) / scale) if scale > 0 else (
        0.0 if not np.any(diff) else float("inf"))
    return rel, float(np.max(np.abs(diff))) if len(diff) else 0.0


def compare(answers: List[Tuple[int, np.ndarray]], refs: Dict[int, dict], mix: dict,
            model: dict) -> Dict[str, float]:
    """answers: (pool index, PCM16 answer) of every utterance checked; refs:
    the reference's result per pool index.  The numbers above but
    `failed`."""
    gap = rel = lsb = 0.0
    for idx, pcm in answers:
        ref = refs[idx]
        gap = max(gap, abs(len(pcm) - expected_samples(mix, model, ref["mel_len"])))
        r, m = answer_errors(pcm, ref["pcm"])
        rel, lsb = max(rel, r), max(lsb, m)
    return {"length_gap": gap, "wav_rel_rms": rel, "wav_max_lsb": lsb}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit (the exact ones at most 0)."""
    lim = dict(EXACT, **limits)
    table = {k: {"value": numbers[k], "limit": lim[k]} for k in lim}
    return all(v["value"] <= v["limit"] for v in table.values()), table
