"""Sequence (time) parallelism: one utterance's vocoder fanned over devices.

The port of zerovox_tpu/parallel/seq.py.  The vocoder is local in time
(convs only), so one long utterance can be cut into exact windows (the
streaming window scheme of models.streaming) and vocoded on different
devices at once, cutting the vocoder's latency for one utterance by up to
the number of devices.  The mel is small (1500 x 80 floats) and each window
is copied to its device; each device holds a replica of the vocoder
weights and of the kernel's packed weights, and its windows are issued on
its own issuing thread.  No ring exchange is needed: the receptive field is
a static local halo carried in the windows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import resolve_device, submit_on_issuing_thread
from ..models.pipeline import replicate_model
from ..models.streaming import StreamingSynthesizer


class TimeParallelVocoder:
    """Vocode one (batch of) mel across several devices, window round-robin.

    devices: the devices, by default every CUDA device (raising without a
    card); a list may name one device several times."""

    def __init__(self, params, cfg: ZeroVoxConfig,
                 devices: Optional[Sequence] = None,
                 chunk_frames: int = 60, overlap: int = 16):
        if devices is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        self.cfg = cfg
        self._s = StreamingSynthesizer(params, cfg, chunk_frames=chunk_frames,
                                       overlap=overlap, device=self.devices[0])
        # the model resident on every participating device
        self._models = [replicate_model(self._s.params_for(None), cfg, d) for d in self.devices]

    def warmup(self, batch: int = 1):
        """Run every window geometry of the full-buffer plan on every
        device once, and wait for the outputs."""
        T, M = self.cfg.max_seq_len, self.cfg.num_mels
        keys = sorted({w[1:] for w in self._s.chunk_plan(T, -(-T // self._s.chunk_frames))})
        futures = []
        for model in self._models:
            for size, e_from, e_frames in keys:
                mel = torch.zeros((batch, size, M), device=model.device)
                futures.append(submit_on_issuing_thread(
                    model.device, self._s.program(size, e_from, e_frames), model, mel))
        for f in futures:
            f.result().cpu()

    def vocode(self, mel: torch.Tensor, mel_len=None) -> np.ndarray:
        """mel (B, T, M) -> wav (B, n_chunks*chunk_frames*hop) as numpy,
        equal to the one-device full run over the covered frames."""
        B, T, M = mel.shape
        mel = torch.as_tensor(mel)
        max_len = T if mel_len is None else int(np.max(np.asarray(mel_len)))
        n_chunks = max(1, -(-max_len // self._s.chunk_frames))
        futures = []
        for c, (ws, size, e_from, e_frames) in enumerate(self._s.chunk_plan(T, n_chunks)):
            model = self._models[c % len(self._models)]           # round-robin
            futures.append(submit_on_issuing_thread(
                model.device, self._s.program(size, e_from, e_frames), model,
                mel[:, ws:ws + size].to(model.device)))
        return np.concatenate([f.result().cpu().numpy() for f in futures], axis=1)
