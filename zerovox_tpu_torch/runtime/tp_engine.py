"""Tensor-parallel serving engine: the daemon over a mesh with model > 1.

The port of zerovox_tpu/runtime/tp_engine.py.  `TTSEngine` serves pure-DP
meshes (each device runs the complete local pipeline on its batch slice).
With a model axis > 1, serving rides `parallel.make_sharded_synthesize`
instead: the encoder and decoder channel-sharded over each data row's
model devices and the vocoder time-sharded per model device, so the MRF
kernel stays on the hot path (parallel/infer.py).

This adapter gives that regime the DP engine's serving surface: the batch
ladder scaled by the data axis, warmup() over every shape a request can
reach, device-side PCM16, the dispatch / fetch split the dynamic batcher
pipelines on, and a hot reload of same-geometry weights.  There are no mel
buckets: the time-sharded vocoder's windows are cut from the full
max_seq_len buffer (time_shard_geometry), so every call vocodes the padded
buffer, as the reference does, and the shapes are the ladder sizes alone.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import resolve_device, to_host_async, wait_host
from ..io.wav import float_to_pcm16_device
from ..models.pipeline import LoadedModel, cast_params, load_model, request_tensors
from .engine import TTSEngine


class TPServingEngine:
    """Serving facade over a tensor-parallel sharded synthesize function."""

    # the ladder helpers only read self.batch_ladder and self.cfg: TTSEngine's
    ladder_size = TTSEngine.ladder_size
    _ladder_chunks = TTSEngine._ladder_chunks
    _trim = TTSEngine._trim
    _take = TTSEngine._take

    def __init__(self, params, cfg: ZeroVoxConfig, mesh,
                 precision: str = "float32",
                 batch_ladder: Sequence[int] = (1, 2, 4, 8),
                 time_shard_vocoder: Optional[bool] = None):
        from ..parallel.infer import make_sharded_synthesize
        from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        if mesh.shape.get(MODEL_AXIS, 1) <= 1:
            raise ValueError("TPServingEngine needs a model axis > 1; "
                             "use TTSEngine for pure-DP meshes")
        if precision == "bfloat16":
            params = cast_params(params, torch.bfloat16)
            cfg = cfg.replace(compute_dtype="bfloat16")
        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(mesh.devices[0, 0])
        self.host_params = params
        self._time_shard = time_shard_vocoder
        self.params, self._fn = make_sharded_synthesize(cfg, mesh, params,
                                                        time_shard_vocoder=time_shard_vocoder)
        self._model = load_model(params, cfg, self.device)
        # no mel buckets under TP (module docstring): /healthz reports the one
        self.mel_buckets: Tuple[int, ...] = (cfg.max_seq_len,)
        if not batch_ladder:
            raise ValueError("batch_ladder must be non-empty")
        n_data = mesh.shape.get(DATA_AXIS, 1)
        # every call splits evenly over the data axis
        self.batch_ladder: Tuple[int, ...] = tuple(sorted(set(
            int(b) * n_data for b in batch_ladder)))

    @property
    def model(self) -> LoadedModel:
        """The whole model on the mesh's first device: what a daemon's
        streaming synthesizer reads (its windows are too short to gain from
        channel sharding)."""
        return self._model

    def _call(self, models, src, pun, sty, nph, pcm16: bool):
        """(wav, mel_len) on the mesh's first device, no host sync: float32,
        or int16 quantised there."""
        res = self._fn(models, src, pun, sty, nph)
        wav = float_to_pcm16_device(res.wav) if pcm16 else res.wav.to(torch.float32)
        return wav, res.mel_len

    def warmup(self, batch: int = 1, pcm16: bool = False):
        """Run every ladder size up to ladder_size(batch) once (both output
        dtypes with pcm16), so the kernel is built and cuDNN has chosen its
        algorithms before the first request."""
        cfg = self.cfg
        for s in (s for s in self.batch_ladder if s <= self.ladder_size(batch)):
            src = torch.zeros((s, cfg.max_n_phonemes), dtype=torch.long)
            style = torch.zeros((s, cfg.d_model))
            for v in ((False, True) if pcm16 else (False,)):
                self._call(self.params, src, src, style, None, v)
        for dev in dict.fromkeys(self.mesh.devices.flat):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def reload_params(self, params):
        """Same-geometry hot swap: the new weights are sharded by the same
        rules onto the same devices (and the first device's whole model
        made anew), then swapped as one reference each; a call in flight
        finishes on the old ones."""
        from ..parallel.infer import make_sharded_synthesize
        if self.cfg.compute_dtype == "bfloat16":
            params = cast_params(params, torch.bfloat16)
        TTSEngine._validate_same_geometry(self.host_params, params)
        models, _ = make_sharded_synthesize(self.cfg, self.mesh, params,
                                            time_shard_vocoder=self._time_shard)
        model = load_model(params, self.cfg, self.device)
        self.host_params = params
        self.params, self._model = models, model

    # ------------------------------------------------------------------ API
    def synthesize_async(self, src_seq, puncts, style_embed, num_phonemes=None,
                         trim: bool = True, pcm16: bool = False
                         ) -> Callable[[], Tuple[List[np.ndarray], np.ndarray]]:
        """Launch without waiting for the device; returns fetch() (the
        contract the DynamicBatcher pipelines on, as TTSEngine's)."""
        models = self.params
        src, pun, sty, nph = request_tensors(self.cfg, self.device, src_seq, puncts,
                                             style_embed, num_phonemes)
        chunks = []
        for padded, n in self._ladder_chunks(range(src.shape[0])):
            wav, mel_len = self._call(models, *(self._take(a, padded)
                                                for a in (src, pun, sty, nph)), pcm16)
            chunks.append((to_host_async(wav), to_host_async(mel_len), n))

        def fetch() -> Tuple[List[np.ndarray], np.ndarray]:
            wavs: List[np.ndarray] = []
            lens = []
            for wav_p, len_p, n in chunks:
                len_n = wait_host(len_p).numpy()[:n]
                wavs.extend(self._trim(wait_host(wav_p).numpy()[:n], len_n, trim))
                lens.append(len_n)
            return wavs, np.concatenate(lens)

        return fetch

    def synthesize(self, src_seq, puncts, style_embed, num_phonemes=None,
                   trim: bool = True, single_rtt: Optional[bool] = None,
                   pcm16: bool = False) -> Tuple[List[np.ndarray], np.ndarray]:
        del single_rtt       # the TP path always vocodes the full buffer in one call
        return self.synthesize_async(src_seq, puncts, style_embed, num_phonemes=num_phonemes,
                                     trim=trim, pcm16=pcm16)()

    def synthesize_packed(self, src_seq, puncts, style_embed, num_phonemes=None,
                          trim: bool = True, pcm16: bool = False):
        """No mel buckets under TP (module docstring): packing is the
        ladder-padded call."""
        return self.synthesize(src_seq, puncts, style_embed, num_phonemes=num_phonemes,
                               trim=trim, pcm16=pcm16)
