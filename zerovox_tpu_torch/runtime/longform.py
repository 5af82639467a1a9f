"""Long-form synthesis: split over-long utterances, batch, concatenate.

The port's copy of zerovox_tpu/runtime/longform.py (host-side numpy).  The
model caps an utterance at max_n_phonemes.  An over-long phoneme sequence is
split into windows of at most that many phonemes, preferring punctuation
marks (nonzero punct ids) as boundaries, which coincide with prosodic
breaks; the windows ride one bucket-packed engine dispatch
(TTSEngine.synthesize_packed) and their waveforms are concatenated in order.

The split is a documented tradeoff, not a parity path: each window is
synthesized without attention context across the boundary, so prosody near
a boundary can differ from what a model of larger capacity would give.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def split_points(puncts: Sequence[int], n: int, cap: int) -> List[int]:
    """End indices (exclusive) of each window of an n-phoneme utterance.

    Greedy: each window ends at the LAST punctuation mark (punct id != 0)
    within the next `cap` phonemes, or at the hard cap when there is none in
    range.  Every window is 1..cap long and the windows partition [0, n).
    """
    if cap < 1:
        raise ValueError(f"cap must be >= 1 (got {cap})")
    pu = np.asarray(puncts)
    ends: List[int] = []
    start = 0
    while start < n:
        if n - start <= cap:
            ends.append(n)
            break
        window = pu[start:start + cap]
        marks = np.flatnonzero(window != 0)
        # split AFTER the punctuation phoneme; fall back to the hard cap
        end = start + (int(marks[-1]) + 1 if marks.size else cap)
        ends.append(end)
        start = end
    return ends


def split_utterance(phonemes: Sequence[int], puncts: Sequence[int],
                    cap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split one over-long utterance into a padded (k, cap) batch.

    Returns (src, pun, num_phonemes): k windows, each zero-padded to `cap`
    exactly like a normal single utterance.
    """
    ph = np.asarray(phonemes, dtype=np.int32)
    pu = np.asarray(puncts, dtype=np.int32)
    if ph.ndim != 1 or pu.shape != ph.shape:
        raise ValueError("phonemes/puncts must be equal-length 1-D")
    ends = split_points(pu, len(ph), cap)
    k = len(ends)
    src = np.zeros((k, cap), np.int32)
    pun = np.zeros((k, cap), np.int32)
    lens = np.zeros((k,), np.int32)
    start = 0
    for i, end in enumerate(ends):
        m = end - start
        src[i, :m] = ph[start:end]
        pun[i, :m] = pu[start:end]
        lens[i] = m
        start = end
    return src, pun, lens


def synthesize_long(engine, phonemes, puncts, style_embed,
                    pcm16: bool = False,
                    max_windows: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Synthesize an utterance of ANY length through `engine` (a TTSEngine).

    Splits at punctuation boundaries (split_utterance), runs all windows as
    one bucket-packed batch with the single style embedding broadcast to
    every window, and concatenates the trimmed waveforms in order.
    Returns (waveform, per-window mel_len).

    max_windows > 0 rejects utterances that split into more windows
    (ValueError): each window is a full utterance of device work, so a
    server exposing this path must bound it like a batch request.
    """
    cap = engine.cfg.max_n_phonemes
    src, pun, lens = split_utterance(phonemes, puncts, cap)
    if max_windows and src.shape[0] > max_windows:
        raise ValueError(
            f"utterance splits into {src.shape[0]} windows, exceeding the "
            f"cap of {max_windows}; send it in several requests")
    style = np.asarray(style_embed, np.float32).reshape(1, -1)
    style = np.repeat(style, src.shape[0], axis=0)
    wavs, mel_len = engine.synthesize_packed(src, pun, style, lens,
                                             trim=True, pcm16=pcm16)
    return np.concatenate(wavs, axis=0), np.asarray(mel_len)
