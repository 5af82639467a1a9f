"""WAV file output (16-bit PCM, mono): the port's copy of zerovox_tpu/io/wav.py.

Pure-Python RIFF writer and reader with the same PCM16 quantisation
(clip to [-1, 1], scale by 32767, truncate toward zero) as the JAX package,
the same quantisation as a torch function for tensors on the device, and an
incremental writer for streamed chunks.
"""

from __future__ import annotations

import struct

import numpy as np


def float_to_pcm16(x: np.ndarray) -> np.ndarray:
    """Clamp to [-1, 1] and convert to int16 (libsndfile-compatible scaling)."""
    x = np.clip(np.asarray(x, dtype=np.float32), -1.0, 1.0)
    return (x * 32767.0).astype(np.int16)


def float_to_pcm16_device(x):
    """float_to_pcm16 on a torch tensor, where it lies (the same clip,
    scale and truncation toward zero, bit for bit): quantising on the
    device halves the bytes a host fetch moves."""
    import torch
    return (torch.clamp(x.to(torch.float32), -1.0, 1.0) * 32767.0).to(torch.int16)


def _wav_header(sampling_rate: int, data_bytes: int) -> bytes:
    """44-byte RIFF/fmt/data header (PCM16 mono)."""
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + data_bytes), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sampling_rate,
                             sampling_rate * 2, 2, 16),
        b"data", struct.pack("<I", data_bytes),
    ])


def write_wav(path: str, wav: np.ndarray, sampling_rate: int, use_native: bool = True):
    """Write a mono waveform as 16-bit PCM WAV.

    Accepts float in [-1, 1] (quantised here, by the native writer where
    use_native and it is available: the same bytes) or int16 (written as-is,
    as the engine's pcm16 option hands it back)."""
    wav = np.asarray(wav)
    if wav.ndim == 2:
        if wav.shape[0] != 1:
            raise ValueError(f"expected mono waveform, got shape {wav.shape}")
        wav = wav[0]
    if wav.dtype != np.int16 and use_native:
        from . import native
        if native.write_wav_native(path, wav, sampling_rate):
            return
    pcm = wav if wav.dtype == np.int16 else float_to_pcm16(wav)
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(_wav_header(sampling_rate, len(data)))
        f.write(data)


class StreamingWavWriter:
    """Incremental 16-bit PCM WAV sink: chunks reach the disk as they arrive.

    Writes a RIFF header with placeholder sizes, appends and flushes each
    PCM chunk at once (a consumer reading the file can start playback), and
    patches the RIFF and data sizes on close."""

    def __init__(self, path: str, sampling_rate: int):
        self.path = path
        self._f = open(path, "wb")
        self._data_bytes = 0
        # sizes (offsets 4 and 40) are placeholders, patched on close
        self._f.write(_wav_header(sampling_rate, 0))
        self._f.flush()

    def write(self, wav_chunk: np.ndarray):
        """Append a chunk; its bytes are on disk on return.  Floats in
        [-1, 1] are quantised here; int16 chunks (quantised on the device,
        pcm16=True streaming) pass through untouched."""
        wav_chunk = np.asarray(wav_chunk)
        if wav_chunk.ndim == 2:
            if wav_chunk.shape[0] != 1:
                raise ValueError(f"expected mono, got shape {wav_chunk.shape}")
            wav_chunk = wav_chunk[0]
        if wav_chunk.dtype != np.int16:
            wav_chunk = float_to_pcm16(wav_chunk)
        data = wav_chunk.tobytes()
        self._f.write(data)
        self._f.flush()
        self._data_bytes += len(data)

    @property
    def samples_written(self) -> int:
        return self._data_bytes // 2

    def close(self):
        if self._f.closed:
            return
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + self._data_bytes))
        self._f.seek(40)
        self._f.write(struct.pack("<I", self._data_bytes))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_wav(path: str):
    """Minimal RIFF reader (PCM16 mono) -> (float32 array in [-1,1], rate)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            body = f.read(size)
            if cid == b"fmt ":
                fmt, ch, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
                if fmt != 1 or ch != 1 or bits != 16:
                    raise ValueError(f"{path}: only PCM16 mono supported")
            elif cid == b"data":
                pcm = np.frombuffer(body, dtype=np.int16)
                return pcm.astype(np.float32) / 32767.0, rate
    raise ValueError(f"{path}: no data chunk")
