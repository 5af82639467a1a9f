"""Streaming synthesis: the vocoder run in chunks, audio emitted as it is made.

The port of zerovox_tpu/models/streaming.py.  A one-shot run vocodes the
whole mel before any audio exists, so its time to first audio is the whole
request's latency.  Here the encoder, length regulator and decoder run once
(the prefix), then the mel is vocoded in windows of `chunk_frames` frames
with `overlap` frames of context on each side, and each window's central
part is handed to the caller as soon as it is on the host.

Correctness: interior windows carry `overlap` frames of *real* mel on each
side; the vocoder's receptive field (hifigan.receptive_field_frames, about
8 frames at the production config) fits inside, so the emitted central part
equals the full run's.  Utterance edges are NOT padded with zero mel (a zero
mel is not a zero activation: the biases and the (mel - mean) / scale
normalisation act on it): the first and last windows end at the true buffer
edge, where the convs' own zero padding applies exactly as in a full run.

The StyleTTS decoder cannot be chunked (its instance norms reduce over the
whole time axis); it runs in the prefix.

With `devices=`, stream sessions rotate over several devices (the daemon
passes the devices of its data-parallel mesh): each session runs on one
device, on a replica of the model made there at its first use, so N
concurrent streams run on N cards instead of queueing on one.  The chunks
of one session stay on its device (parallel.seq fans one utterance's
windows out over devices).
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import on_issuing_thread, resolve_device, to_host_async, wait_host
from ..io.wav import float_to_pcm16_device
from . import hifigan
from .pipeline import (LoadedModel, compute_dtype, front, load_model, replicate_model,
                       request_tensors)

Window = Tuple[int, int, int, int]   # (window_start, window_size, emit_from, emit_frames)


def chunk_plan(T: int, n_chunks: int, chunk_frames: int, overlap: int) -> List[Window]:
    """Static plan: (window_start, window_size, emit_from, emit_frames)
    per chunk of a T-frame mel buffer.

    Every window edge either carries >= `overlap` frames of real mel
    context (the vocoder's receptive field fits inside, so the emitted
    central part is exact) or coincides with a true buffer edge (where
    the convs' own zero padding applies exactly as in a full run).  Works
    for any chunk_frames, including a short final chunk when it does not
    divide T."""
    ov, ch = overlap, chunk_frames
    plan = []
    for c in range(n_chunks):
        start = c * ch
        if start >= T:
            break
        end = min(start + ch, T)
        ws = max(start - ov, 0)
        we = min(end + ov, T)
        plan.append((ws, we - ws, start - ws, end - start))
    return plan


class StreamingSynthesizer:
    """Two phases: the prefix (encoder + length regulator + decoder at
    max_seq_len), then one vocoder call per window, each through the MRF
    kernel on a card."""

    def __init__(self, params, cfg: ZeroVoxConfig,
                 chunk_frames: int = 60, overlap: int = 16,
                 pcm16: bool = False, ahead: Optional[int] = None,
                 device="cuda", devices: Optional[Sequence] = None):
        """pcm16=True quantises every chunk on the device
        (io.wav.float_to_pcm16_device) and yields int16: half the bytes per
        host fetch, bit-identical to quantising the float chunks on the host.

        ahead = how many windows past the one being yielded may be launched
        (None = all of them).  A window's result is copied to pinned host
        memory behind its launches, with an event; stream() waits on the
        event of the window it yields, so launches run ahead of the fetches.
        The output is identical for every `ahead`; a window bounds the work
        wasted on a client that abandons the stream.

        cfg.compute_dtype "bfloat16" runs the serving dtype: params are cast
        here (and in set_params), as TTSEngine(precision="bfloat16") does.

        params may be a LoadedModel (TTSEngine.model) on this device and in
        cfg's dtype: the synthesizer then reads those weights and packed
        weights and keeps no copy of its own.

        devices = rotate stream sessions over these devices (session_device);
        each gets a replica of the model at its first session (params_for).
        Output is the same on every device: the same program on the same
        weights."""
        if chunk_frames <= 0 or overlap < 0:
            raise ValueError("chunk_frames must be > 0, overlap >= 0")
        if ahead is not None and ahead < 1:
            raise ValueError("ahead must be >= 1 (or None for unbounded)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.chunk_frames = chunk_frames
        self.overlap = overlap
        self.pcm16 = pcm16
        self.ahead = ahead
        self._model = load_model(params, cfg, self.device)
        self.devices = [resolve_device(d) for d in devices] if devices else None
        self._replicas: Dict[torch.device, LoadedModel] = {}
        self._dev_lock = threading.Lock()
        self._rr = itertools.count()

    @property
    def params(self) -> dict:
        return self._model.params

    def set_params(self, params):
        """Hot-swap the weights (same geometry; a params tree or a
        LoadedModel): cast and packed for the MRF kernel as the constructor
        did, swapped as one reference, so a stream in flight finishes on
        the weights it started with.  The replicas on other devices are
        dropped; sessions running on them finish there."""
        model = load_model(params, self.cfg, self.device)
        with self._dev_lock:
            self._model = model
            self._replicas = {}

    # ------------------------------------------------------ device rotation
    def session_device(self, device=None) -> Optional[torch.device]:
        """The device the next stream session runs on: `device` where given
        (pinning), else the next of `devices` in rotation, else None (the
        synthesizer's own device)."""
        if device is not None:
            return resolve_device(device)
        if not self.devices:
            return None
        return self.devices[next(self._rr) % len(self.devices)]

    def params_for(self, device) -> LoadedModel:
        """The model on `device` (None: the synthesizer's own), replicated
        there at its first use and kept until set_params.  The replica is
        made outside the lock (it moves and packs every weight), so other
        sessions are not held up behind it; two sessions racing on a fresh
        device may both make one, and the first stored wins."""
        with self._dev_lock:
            src = self._model
            if device is None or device == src.device:
                return src
            rep = self._replicas.get(device)
        if rep is not None:
            return rep
        rep = replicate_model(src, self.cfg, device)
        with self._dev_lock:
            if self._model is not src:
                # a hot reload swapped the weights meanwhile: this session
                # finishes on the copy it made, the next replicates anew
                return rep
            return self._replicas.setdefault(device, rep)

    # ------------------------------------------------------------- programs
    def program(self, window: int, emit_from: int, emit_frames: int
                ) -> Callable[[LoadedModel, torch.Tensor], torch.Tensor]:
        """The vocoder program of one window geometry: a function of
        (model, mel window (B, window, num_mels)) that returns the emitted
        samples (B, emit_frames * hop) on the device, float32 or (pcm16)
        int16.  Plain functions: nothing is compiled or cached."""
        hop = self.cfg.hop_size

        @torch.inference_mode()
        def launch(model: LoadedModel, mel_window: torch.Tensor) -> torch.Tensor:
            wav = hifigan.vocode(model.params, self.cfg, mel_window, model.packed)
            wav = wav[:, emit_from * hop: (emit_from + emit_frames) * hop]
            return float_to_pcm16_device(wav) if self.pcm16 else wav.to(torch.float32)

        def run(model: LoadedModel, mel_window: torch.Tensor) -> torch.Tensor:
            if mel_window.shape[1] != window:
                raise ValueError(f"window of {mel_window.shape[1]} frames, want {window}")
            return on_issuing_thread(model.device, launch, model, mel_window, span="issue.stream")

        return run

    def chunk_plan(self, T: int, n_chunks: int) -> List[Window]:
        """chunk_plan() at this synthesizer's chunk_frames and overlap."""
        return chunk_plan(T, n_chunks, self.chunk_frames, self.overlap)

    def _vocode_window(self, model: LoadedModel, mel: torch.Tensor, w: Window) -> torch.Tensor:
        ws, size, e_from, e_frames = w
        return self.program(size, e_from, e_frames)(model, mel[:, ws:ws + size])

    def vocode_chunks(self, mel: torch.Tensor, n_chunks: int) -> Iterator[torch.Tensor]:
        """Yield (B, emit_frames * hop) waveform chunks of a mel on the
        synthesizer's device, matching the full vocoder run (the final
        chunk may be shorter)."""
        model = self._model
        for w in self.chunk_plan(mel.shape[1], n_chunks):
            yield self._vocode_window(model, mel, w)

    def _prefix(self, model: LoadedModel, src_seq, puncts, style_embed, num_phonemes):
        """Request arrays -> device (mel, mel_len, max mel_len), no host
        sync; launched on the process's issuing thread
        (device.on_issuing_thread), recorded as "issue.stream" as the
        windows are."""
        return on_issuing_thread(model.device, self._issue_prefix, model, src_seq, puncts,
                                 style_embed, num_phonemes, span="issue.stream")

    @torch.inference_mode()
    def _issue_prefix(self, model: LoadedModel, src_seq, puncts, style_embed, num_phonemes):
        cfg = self.cfg
        src, pun, sty, nph = request_tensors(cfg, model.device, src_seq, puncts, style_embed,
                                             num_phonemes)
        sty = sty.to(compute_dtype(cfg))
        mel, mel_len, _ = front(model.params, cfg, src, pun, sty, nph)
        return mel, mel_len, mel_len.max()

    def warmup(self, batch: int = 1):
        """Run the prefix and every window geometry of the full-buffer plan
        (which covers every shorter plan) once, off the latency path: on a
        card this builds the MRF kernel and lets cuDNN choose its
        algorithms for each window length; with `devices`, on each of them
        (which also makes their replicas)."""
        cfg = self.cfg
        T = cfg.max_seq_len
        zeros = np.zeros((batch, cfg.max_n_phonemes), np.int64)
        for dev in dict.fromkeys(self.devices or [None]):
            model = self.params_for(dev)
            mel, _, _ = self._prefix(model, zeros, zeros,
                                     np.zeros((batch, cfg.d_model), np.float32),
                                     np.zeros((batch,), np.int64))
            seen = set()
            for w in self.chunk_plan(T, -(-T // self.chunk_frames)):
                if w[1:] not in seen:
                    seen.add(w[1:])
                    self._vocode_window(model, mel, w)
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)

    # ------------------------------------------------------------------ API
    def stream(self, src_seq, puncts, style_embed, num_phonemes=None, device=None
               ) -> Iterator[np.ndarray]:
        """Yield waveform chunks (B, chunk_frames * hop) as they are
        computed, float32 or (pcm16) int16 numpy arrays.

        The first yield is the time-to-first-audio point.  Chunks past the
        longest mel_len of the batch are not computed (a one-shot run
        vocodes the padded tail too).  The session runs on
        session_device(device)."""
        model = self.params_for(self.session_device(device))
        mel, _, max_len_dev = self._prefix(model, src_seq, puncts, style_embed, num_phonemes)
        T = mel.shape[1]

        # Chunk 0's geometry does not depend on mel_len: launch it before
        # mel_len is read, and queue the mel_len copy behind its launches,
        # so that the read waits for nothing chunk 0 does not need anyway
        first = to_host_async(self._vocode_window(model, mel, self.chunk_plan(T, 1)[0]))
        max_len = to_host_async(max_len_dev)
        first_h = wait_host(first).numpy()
        n_chunks = max(1, -(-int(wait_host(max_len)) // self.chunk_frames))
        yield first_h

        # launches run up to `ahead` windows (all of them, when None) ahead
        # of the fetches; each result is already on its way to the host
        plan = self.chunk_plan(T, n_chunks)[1:]
        limit = len(plan) if self.ahead is None else self.ahead
        pending: deque = deque()
        for w in plan:
            while len(pending) >= max(1, limit):
                yield wait_host(pending.popleft()).numpy()
            pending.append(to_host_async(self._vocode_window(model, mel, w)))
        while pending:
            yield wait_host(pending.popleft()).numpy()

    def synthesize_full(self, src_seq, puncts, style_embed, num_phonemes=None
                        ) -> Tuple[np.ndarray, int]:
        """Collect the stream into one waveform (B, samples) and its length."""
        chunks = list(self.stream(src_seq, puncts, style_embed, num_phonemes))
        wav = np.concatenate(chunks, axis=1)
        return wav, wav.shape[1]
