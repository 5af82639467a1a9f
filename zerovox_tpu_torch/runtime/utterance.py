"""The request formats of one utterance, shared by the CLI, the daemon
(runtime/server.py) and the client (runtime/client.py).

JSON schema: {"phonemes": [...], "puncts": [...], "style": [...]}.

Raw-binary body (Content-Type: application/octet-stream), the latency fast
path: b"ZVB1" + uint32 n + n int32 phonemes + n int32 puncts + d_model
float32 style, every field little-endian.  Parsing it is three zero-copy
np.frombuffer views instead of a JSON decode of some 650 numbers.

The port's copy of zerovox_tpu/runtime/server.py's parse_utterance_arrays,
utterance_from_dict, utterance_to_binary and utterance_from_binary: the same
bytes on the wire, so either package's client talks to either daemon.
"""

from __future__ import annotations

import struct
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


BINARY_MAGIC = b"ZVB1"


def utterance_to_binary(phonemes, style, puncts=None) -> bytes:
    """Pack one utterance as the daemon's raw-binary request body (see the
    module docstring).  The count is written little-endian explicitly, like
    the arrays, whatever the host's byte order."""
    ph = np.ascontiguousarray(phonemes, dtype="<i4").reshape(-1)
    pu = (np.zeros_like(ph) if puncts is None
          else np.ascontiguousarray(puncts, dtype="<i4").reshape(-1))
    if pu.shape != ph.shape:
        raise ValueError("phonemes/puncts must be equal length")
    st = np.ascontiguousarray(style, dtype="<f4").reshape(-1)
    return (BINARY_MAGIC + struct.pack("<I", len(ph))
            + ph.tobytes() + pu.tobytes() + st.tobytes())


def utterance_from_binary(buf: bytes, cfg: ZeroVoxConfig
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """Parse the raw-binary utterance body into padded (src, pun, style, n):
    the binary twin of utterance_from_dict, with the same validation
    (ValueError, which the daemon answers with HTTP 400)."""
    P = cfg.max_n_phonemes
    if len(buf) < 8 or buf[:4] != BINARY_MAGIC:
        raise ValueError("binary utterance: bad magic (want b'ZVB1')")
    n = int(np.frombuffer(buf, "<u4", 1, 4)[0])
    if n > P:
        raise ValueError(f"{n} phonemes exceeds the model's "
                         f"max_n_phonemes={P}; split the utterance")
    need = 8 + 8 * n + 4 * cfg.d_model
    if len(buf) != need:
        raise ValueError(f"binary utterance: body is {len(buf)} bytes, "
                         f"expected {need} for n={n}, "
                         f"d_model={cfg.d_model}")
    ph = np.frombuffer(buf, "<i4", n, 8)
    pu = np.frombuffer(buf, "<i4", n, 8 + 4 * n)
    style = np.frombuffer(buf, "<f4", cfg.d_model,
                          8 + 8 * n).reshape(1, -1).copy()
    src = np.zeros((1, P), np.int32)
    pun = np.zeros((1, P), np.int32)
    src[0, :n] = ph
    pun[0, :n] = pu
    return src, pun, style, np.asarray([n], np.int32)
