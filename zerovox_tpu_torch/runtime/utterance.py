"""Utterance JSON schema: {"phonemes": [...], "puncts": [...], "style": [...]}.

The port's copy of zerovox_tpu/runtime/server.py's parse_utterance_arrays /
utterance_from_dict (the daemon itself is a later slice).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import ZeroVoxConfig


def parse_utterance_arrays(d: dict, cfg: ZeroVoxConfig
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Validate the utterance JSON schema into raw (ph, pu, style) arrays of
    any length."""
    for key in ("phonemes", "style"):
        if key not in d:
            raise ValueError(f"missing required key {key!r} "
                             "(need phonemes, style; optional puncts)")
    try:
        ph = np.asarray(d["phonemes"], dtype=np.int32)
        pu = np.asarray(d.get("puncts", np.zeros_like(ph)), dtype=np.int32)
        style = np.asarray(d["style"], dtype=np.float32).reshape(1, -1)
    except (TypeError, ValueError, OverflowError) as e:
        raise ValueError(f"malformed utterance arrays: {e}")
    if ph.ndim != 1 or pu.shape != ph.shape:
        raise ValueError("phonemes/puncts must be equal-length 1-D lists")
    if style.shape[1] != cfg.d_model:
        raise ValueError(f"style embedding has {style.shape[1]} dims, "
                         f"model wants {cfg.d_model}")
    return ph, pu, style


def utterance_from_dict(d: dict, cfg: ZeroVoxConfig
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Parse the utterance JSON schema into padded (src, pun, style, n).

    Raises ValueError on schema violations, including more phonemes than
    max_n_phonemes (an explicit error rather than silently shortened audio).
    """
    P = cfg.max_n_phonemes
    ph, pu, style = parse_utterance_arrays(d, cfg)
    if len(ph) > P:
        raise ValueError(f"{len(ph)} phonemes exceeds the model's "
                         f"max_n_phonemes={P}; split the utterance")
    n = len(ph)
    src = np.zeros((1, P), np.int32)
    pun = np.zeros((1, P), np.int32)
    src[0, :n] = ph
    pun[0, :n] = pu
    return src, pun, style, np.asarray([n], np.int32)
