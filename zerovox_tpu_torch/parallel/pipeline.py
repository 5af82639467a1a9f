"""Pipeline parallelism: encoder / decoder and vocoder on different devices.

The port of zerovox_tpu/parallel/pipeline.py.  The front (encoder, length
regulator, decoder) runs on one device and the vocoder on another, the mel
hopping between them; each device's launches are issued on its own issuing
thread, so the front device computes utterance N+1's mel while the back
device vocodes utterance N.

In-flight work is bounded (`max_in_flight`, default 4): utterance
k + max_in_flight is launched only after utterance k's result has been
fetched, so a long feed never piles every utterance's mel and waveform on
the devices at once.  `run_iter` yields results as they complete.  For this
model the pure-DP mesh engine remains the better serving shape (the whole
pipeline fits on one device, so DP gets N devices' throughput with no
traffic between them); the pipeline is the shape for a stage whose weights
or activations outgrow one device.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import resolve_device, submit_on_issuing_thread
from ..models import hifigan
from ..models.pipeline import (LoadedModel, compute_dtype, front, pack_model, place_params,
                               request_tensors)


class PipelinedTTS:
    """Two-stage device pipeline over a sequence of utterance batches.

    front_device / back_device default to the first two CUDA devices
    (raising without a card, or with one card unless both are given; on
    one card both may be "cuda:0")."""

    def __init__(self, params, cfg: ZeroVoxConfig,
                 front_device=None, back_device=None,
                 max_in_flight: int = 4):
        if front_device is None or back_device is None:
            resolve_device("cuda")
            if torch.cuda.device_count() < 2:
                raise ValueError("pipeline placement needs >= 2 devices")
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self.front_device = resolve_device(front_device or "cuda:0")
        self.back_device = resolve_device(back_device or "cuda:1")
        self.cfg = cfg
        self.max_in_flight = max_in_flight
        # each stage holds the weights it runs: the front the encoder and
        # decoder, the back the vocoder (and its packed weights)
        self._front_model = LoadedModel(
            place_params({"encoder": params["encoder"], "decoder": params["decoder"]},
                         cfg, self.front_device), None, self.front_device)
        self._back_model = pack_model(
            place_params({"vocoder": params["vocoder"]}, cfg, self.back_device), cfg,
            self.back_device)

    @torch.inference_mode()
    def _front(self, src, pun, style, n):
        mel, mel_len, _ = front(self._front_model.params, self.cfg, src, pun,
                                style.to(compute_dtype(self.cfg)), n)
        return mel, mel_len

    @torch.inference_mode()
    def _back(self, front_future):
        mel, mel_len = front_future.result()
        wav = hifigan.vocode(self._back_model.params, self.cfg, mel.to(self.back_device),
                             self._back_model.packed)
        return wav, mel_len

    def _dispatch(self, batch: Tuple):
        """Launch one batch's front on the front device and its vocoder on
        the back device, without waiting: a Future of device (wav, mel_len).
        The back device's issuing thread waits for the front's launches
        (not for its device work) before it launches the vocoder."""
        src, pun, style, n = request_tensors(self.cfg, self.front_device, *batch)
        f = submit_on_issuing_thread(self.front_device, self._front, src, pun, style, n)
        return submit_on_issuing_thread(self.back_device, self._back, f)

    @staticmethod
    def _fetch(pending) -> Tuple[np.ndarray, np.ndarray]:
        wav, mel_len = pending.result()
        return wav.float().cpu().numpy(), mel_len.cpu().numpy()

    def warmup(self, batch: int = 1):
        """Run both stages once at this batch size and fetch the outputs."""
        cfg = self.cfg
        src = np.zeros((batch, cfg.max_n_phonemes), np.int64)
        style = np.zeros((batch, cfg.d_model), np.float32)
        n = np.full((batch,), cfg.max_n_phonemes, np.int64)
        self._fetch(self._dispatch((src, src, style, n)))

    def run_iter(self, batches: Iterable[Tuple]) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Stream host (wav, mel_len) numpy results in input order.

        At most `max_in_flight` utterances are staged on the devices at once:
        utterance k + max_in_flight is launched only after utterance k's
        result is fetched."""
        pending: deque = deque()
        for batch in batches:
            while len(pending) >= self.max_in_flight:
                yield self._fetch(pending.popleft())
            pending.append(self._dispatch(batch))
        while pending:
            yield self._fetch(pending.popleft())

    def run(self, batches: Iterable[Tuple]) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(src, puncts, style, num_phonemes), ...] -> [(wav, mel_len), ...]
        on the host, in input order (run_iter collected)."""
        return list(self.run_iter(batches))
