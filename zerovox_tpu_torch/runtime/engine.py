"""Serving engine: mel-length buckets, batch ladder, batched synthesis on one device.

The engine runs the encoder + length regulator + StyleTTS decoder at the
full max_seq_len (the decoder's InstanceNorms reduce over the whole padded
time axis, so they must see the same padded buffer as the reference), reads
the predicted mel lengths, and runs only the heavy vocoder at the smallest
bucket that covers mel_len plus the vocoder's receptive field, so the
trimmed audio equals the full-length run's.

Batches are padded (first row repeated) to the smallest size of the batch
ladder and split at its top, as in the JAX package: the set of shapes a
serving process ever runs stays len(mel_buckets) x len(batch_ladder), and
the ladder top bounds the memory of one dispatch.

Multi-device serving: pass `mesh=` (a pure-DP parallel.Mesh, model axis 1)
and every front and vocoder call is split over the mesh's data devices,
each running the complete local pipeline (the MRF kernel included) on its
slice of the batch, on its own replica of the model and its own issuing
thread, with no exchange between devices; the slices are gathered on the
mesh's first device.  The batch ladder scales by the data size so that
every call splits evenly.  Tensor-parallel serving is
runtime.tp_engine.TPServingEngine.

The engine records (utils.profiling) its launches on the issuing thread
("issue.front", "issue.vocode"), the calling thread's waits for the card
("engine.sync") and, for each vocoder call, a "vocoder.frames" counter: the
frames its real rows need and the frames it vocodes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import (on_issuing_thread, resolve_device, submit_on_issuing_thread,
                      to_host_async, wait_host)
from ..io.wav import float_to_pcm16_device
from ..models import hifigan
from ..models.pipeline import (LoadedModel, compute_dtype, front, load_model, pack_model,
                               place_params, replicate_model, request_tensors)
from ..utils import profiling


def _leaves(tree, path=""):
    """(path, tensor) for every leaf of a params tree, in tree order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _to_host(t: torch.Tensor) -> np.ndarray:
    """t on the host: the calling thread waits for the card ("engine.sync")."""
    with profiling.span("engine.sync"):
        return t.cpu().numpy()


def _count_frames(mel_len: np.ndarray, rows: int, bucket: int):
    """The "vocoder.frames" counter of one vocoder call: the frames its real
    rows need (their mel lengths) and the frames it vocodes (every row,
    ladder padding included, at the bucket's length)."""
    profiling.count("vocoder.frames", int(np.sum(mel_len)), rows * bucket)


class TTSEngine:
    """High-level synthesis engine over a loaded model on one device, or on
    the data devices of a pure-DP mesh."""

    def __init__(self, params, cfg: ZeroVoxConfig,
                 mel_buckets: Sequence[int] = (256, 512, 1024),
                 precision: str = "float32",
                 batch_ladder: Sequence[int] = (1, 2, 4, 8),
                 device="cuda", mesh=None):
        """precision "bfloat16" is the serving dtype: the weights are cast
        once, here (and again in reload_params), the activations follow
        cfg.compute_dtype, and the MRF kernel runs its bf16 mode.

        mesh: a pure-DP parallel.Mesh; the engine then runs on its devices
        (`device` is not read) and its ladder is scaled by the data size."""
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import MODEL_AXIS
            if mesh.shape.get(MODEL_AXIS, 1) != 1:
                raise ValueError(
                    "TTSEngine serves pure-DP meshes (model axis == 1); use "
                    "runtime.tp_engine.TPServingEngine or "
                    "parallel.make_sharded_synthesize for TP inference")
            self._devices = [resolve_device(d) for d in mesh.devices[:, 0]]
        else:
            self._devices = [resolve_device(device)]
        self.device = self._devices[0]
        if precision == "bfloat16":
            cfg = cfg.replace(compute_dtype="bfloat16")
        self.cfg = cfg
        # the caller's tree, as given (a single-device consumer must not
        # inherit the mesh's placement)
        self.host_params = params
        self._models = self._replicas(load_model(params, cfg, self.device))
        # truncating the mel at `bucket` only perturbs vocoder outputs within
        # the receptive field of the cut: mel_len + margin <= bucket keeps
        # the trimmed waveform equal to the full run's
        self.margin = hifigan.receptive_field_frames(cfg)
        bks = sorted(set(int(b) for b in mel_buckets if b < cfg.max_seq_len))
        self.mel_buckets: Tuple[int, ...] = tuple(bks) + (cfg.max_seq_len,)
        if not batch_ladder:
            raise ValueError("batch_ladder must be non-empty")
        self.batch_ladder: Tuple[int, ...] = tuple(sorted(set(
            int(b) for b in batch_ladder)))
        if len(self._devices) > 1:
            # every call must split evenly over the data devices: each rung
            # is a whole number of rows per device (a B=1 request pads to
            # one row per device and runs in one device's B=1 time)
            self.batch_ladder = tuple(b * len(self._devices) for b in self.batch_ladder)

    # -------------------------------------------------------------- weights
    def _replicas(self, model: LoadedModel) -> Tuple[LoadedModel, ...]:
        """`model` (on the first data device) and its replica on every other
        one, in data order; a device named twice holds one."""
        made = {model.device: model}
        for dev in self._devices:
            if dev not in made:
                made[dev] = replicate_model(model, self.cfg, dev)
        return tuple(made[dev] for dev in self._devices)

    @property
    def model(self) -> LoadedModel:
        """The weights and packed weights in use on the engine's (first)
        device, as one reference (what StreamingSynthesizer takes to share
        them)."""
        return self._models[0]

    @property
    def params(self) -> dict:
        return self._models[0].params

    @property
    def vocoder_packed(self) -> Optional[list]:
        return self._models[0].packed

    def reload_params(self, params):
        """Hot-swap the model's weights for others of the same geometry
        (tree structure, shapes and dtypes; anything else raises ValueError
        and needs a new engine).  The new weights are cast as the
        constructor cast the old ones and packed anew for the MRF kernel,
        on every data device; weights and packed weights of all of them are
        swapped as one reference, so a call in flight finishes on the old
        ones and never mixes the two."""
        placed = place_params(params, self.cfg, self.device)
        self._validate_same_geometry(self._models[0].params, placed)
        models = self._replicas(pack_model(placed, self.cfg, self.device))
        self.host_params = params
        self._models = models

    @staticmethod
    def _validate_same_geometry(old_params, new_params):
        """Raise ValueError unless new_params has the tree structure and the
        per-leaf shapes and dtypes of old_params."""
        old, new = list(_leaves(old_params)), list(_leaves(new_params))
        if [k for k, _ in old] != [k for k, _ in new]:
            raise ValueError("checkpoint parameter tree differs from the loaded model's: "
                             "geometry changed, a new engine is required")
        bad = [(k, tuple(b.shape), b.dtype, tuple(a.shape), a.dtype)
               for (k, a), (_, b) in zip(old, new)
               if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype]
        if bad:
            raise ValueError("checkpoint geometry mismatch (a new engine is required): "
                             + "; ".join(f"{k}: {bs}/{bd} vs engine {as_}/{ad}"
                                         for k, bs, bd, as_, ad in bad[:3]))

    # ------------------------------------------------------------ programs
    def _split(self, span: str, issue, models: Tuple[LoadedModel, ...], *args):
        """issue(*args, model) on the issuing thread of each model's device
        (device.on_issuing_thread; recorded as the span `span`), whatever
        thread calls: on the whole batch with one device, else on each data
        device's slice of the rows, the outputs gathered on the engine's
        device.  No host sync."""
        if len(models) == 1:
            return on_issuing_thread(models[0].device, issue, *args, models[0], span=span)
        parts = [a.tensor_split(len(models)) for a in args]
        futures = [submit_on_issuing_thread(m.device, issue,
                                            *(p[i].to(m.device) for p in parts), m, span=span)
                   for i, m in enumerate(models)]
        outs = [f.result() for f in futures]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[j].to(self.device) for o in outs])
                         for j in range(len(outs[0])))
        return torch.cat([o.to(self.device) for o in outs])

    def _front(self, src_seq, puncts, style_embed, num_phonemes,
               models: Optional[Tuple[LoadedModel, ...]] = None):
        """Encoder + length regulator + decoder at full max_seq_len, on
        device tensors; no host sync."""
        return self._split("issue.front", self._issue_front, models or self._models,
                           src_seq, puncts, style_embed, num_phonemes)

    @torch.inference_mode()
    def _issue_front(self, src_seq, puncts, style_embed, num_phonemes, model: LoadedModel):
        mel, mel_len, _ = front(model.params, self.cfg, src_seq, puncts,
                                style_embed.to(compute_dtype(self.cfg)), num_phonemes)
        return mel, mel_len

    def _vocode(self, mel_b: torch.Tensor, pcm16: bool,
                models: Optional[Tuple[LoadedModel, ...]] = None) -> torch.Tensor:
        """Vocoder on a bucket-length mel, left on the device: int16 with
        pcm16 (quantised there, so the host fetch moves half the bytes),
        else float32 (a bf16 waveform is widened for the caller).  Issued as
        _front."""
        issue = self._issue_vocode_pcm16 if pcm16 else self._issue_vocode
        return self._split("issue.vocode", issue, models or self._models, mel_b)

    @torch.inference_mode()
    def _issue_vocode(self, mel_b: torch.Tensor, model: LoadedModel) -> torch.Tensor:
        return hifigan.vocode(model.params, self.cfg, mel_b, model.packed).to(torch.float32)

    @torch.inference_mode()
    def _issue_vocode_pcm16(self, mel_b: torch.Tensor, model: LoadedModel) -> torch.Tensor:
        return float_to_pcm16_device(hifigan.vocode(model.params, self.cfg, mel_b,
                                                    model.packed))

    def _back(self, mel_b: torch.Tensor, pcm16: bool,
              models: Optional[Tuple[LoadedModel, ...]] = None) -> np.ndarray:
        """_vocode fetched to the host."""
        return _to_host(self._vocode(mel_b, pcm16, models))

    # ------------------------------------------------------------- geometry
    def pick_bucket(self, mel_len: int) -> int:
        """Smallest bucket covering mel_len + the vocoder receptive field."""
        need = min(int(mel_len) + self.margin, self.cfg.max_seq_len)
        for b in self.mel_buckets:
            if need <= b:
                return b
        return self.mel_buckets[-1]

    def ladder_size(self, n: int) -> int:
        """Smallest ladder batch covering n (capped at the ladder top)."""
        for s in self.batch_ladder:
            if n <= s:
                return s
        return self.batch_ladder[-1]

    def _ladder_chunks(self, idxs: Sequence[int]):
        """Split an index list into ladder-top chunks, each padded (first
        index repeated) up to its ladder size.  Yields (padded_idxs, n_real)."""
        top = self.batch_ladder[-1]
        for c0 in range(0, len(idxs), top):
            chunk = list(idxs[c0:c0 + top])
            size = self.ladder_size(len(chunk))
            yield chunk + [chunk[0]] * (size - len(chunk)), len(chunk)

    def group_by_bucket(self, predicted_lens: Sequence[int]) -> Dict[int, List[int]]:
        """Group utterance indices by their mel bucket (for batch packing)."""
        groups: Dict[int, List[int]] = {}
        for i, L in enumerate(predicted_lens):
            groups.setdefault(self.pick_bucket(int(L)), []).append(i)
        return groups

    def warmup(self, batch: int = 1, pcm16: bool = False):
        """Run every shape serving can hit for batches up to `batch` once:
        the front and the vocoder at each bucket, at every ladder size
        <= ladder_size(batch).  On a card this builds the MRF kernel and
        lets cuDNN pick its algorithms before the first request."""
        cfg = self.cfg
        for s in (s for s in self.batch_ladder if s <= self.ladder_size(batch)):
            src = torch.zeros((s, cfg.max_n_phonemes), dtype=torch.long,
                              device=self.device)
            style = torch.zeros((s, cfg.d_model), device=self.device)
            nph = torch.zeros((s,), dtype=torch.long, device=self.device)
            mel, _ = self._front(src, src, style, nph)
            for b in self.mel_buckets:
                for v in ((False, True) if pcm16 else (False,)):
                    self._back(mel[:, :b], v)
        for dev in dict.fromkeys(self._devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------ API
    def synthesize(self, src_seq, puncts, style_embed, num_phonemes=None,
                   trim: bool = True, single_rtt: bool = False, pcm16: bool = False
                   ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Batched synthesis with bucket dispatch: the whole batch vocodes at
        the bucket of its longest utterance (synthesize_packed routes each
        bucket group separately).

        Returns (per-utterance waveforms, trimmed to mel_len*hop when
        trim=True, else the full padded buffer; mel_len array).

        single_rtt=True delegates to synthesize_async() + fetch: the
        vocoder runs at the largest bucket, launched before mel_len is read,
        so the call waits on the device once instead of twice.  It is off
        by default, where the JAX package turns it on for B == 1: there a
        host sync is a round trip to a remote device and costs more than
        vocoding 1500 frames instead of 256; on a local card a sync costs
        microseconds and the longer vocode milliseconds (PERF.md)."""
        if single_rtt:
            return self.synthesize_async(src_seq, puncts, style_embed,
                                         num_phonemes=num_phonemes, trim=trim, pcm16=pcm16)()
        models = self._models
        mel, mel_len_h = self._run_front(src_seq, puncts, style_embed, num_phonemes, models)
        # trim=False promises the reference's full padded buffer, so it
        # vocodes at the max bucket
        bucket = (self.pick_bucket(int(mel_len_h.max()))
                  if trim else self.mel_buckets[-1])
        outs = []
        for padded, n in self._ladder_chunks(range(mel.shape[0])):
            outs.append(self._back(self._take(mel, padded)[:, :bucket], pcm16, models)[:n])
            _count_frames(mel_len_h[padded[:n]], len(padded), bucket)
        return self._trim(np.concatenate(outs, axis=0), mel_len_h, trim), mel_len_h

    def synthesize_async(self, src_seq, puncts, style_embed, num_phonemes=None,
                         trim: bool = True, pcm16: bool = False
                         ) -> Callable[[], Tuple[List[np.ndarray], np.ndarray]]:
        """Launch synthesis without waiting for the device; returns a
        fetch() closure.

        The front and a vocoder at the largest bucket (which covers every
        mel length, so nothing is ever redone) are launched with no host
        sync, ladder chunk by ladder chunk, and each chunk's waveform and
        mel_len start their copy into pinned host memory behind it.
        fetch() waits for each chunk's copies and trims on the host.  A
        caller can launch batch k+1 while batch k is still computing or
        being fetched."""
        models = self._models
        src, pun, sty, nph = self._inputs(src_seq, puncts, style_embed, num_phonemes)
        bucket = self.mel_buckets[-1]
        chunks = []
        for padded, n in self._ladder_chunks(range(src.shape[0])):
            mel, mel_len = self._front(*(self._take(a, padded) for a in (src, pun, sty, nph)),
                                       models)
            wav = self._vocode(mel[:, :bucket], pcm16, models)
            chunks.append((to_host_async(wav), to_host_async(mel_len), n, len(padded)))

        def fetch() -> Tuple[List[np.ndarray], np.ndarray]:
            wavs: List[np.ndarray] = []
            lens = []
            for wav_p, len_p, n, size in chunks:
                with profiling.span("engine.sync"):
                    len_n = wait_host(len_p).numpy()[:n]
                    wav_h = wait_host(wav_p).numpy()[:n]
                _count_frames(len_n, size, bucket)
                wavs.extend(self._trim(wav_h, len_n, trim))
                lens.append(len_n)
            return wavs, np.concatenate(lens)

        return fetch

    def synthesize_packed(self, src_seq, puncts, style_embed,
                          num_phonemes=None, trim: bool = True,
                          pcm16: bool = False
                          ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Bucket-packed batched synthesis: one vocoder dispatch per bucket
        group (ladder-padded), so short utterances in a mixed batch do not
        pay the longest one's compute.  Outputs match synthesize()."""
        models = self._models
        mel, mel_len_h = self._run_front(src_seq, puncts, style_embed, num_phonemes, models)
        B = mel.shape[0]
        hop = self.cfg.hop_size
        wavs: List[Optional[np.ndarray]] = [None] * B
        groups = (self.group_by_bucket(mel_len_h) if trim
                  else {self.mel_buckets[-1]: list(range(B))})
        for bucket, idxs in groups.items():
            for padded, n in self._ladder_chunks(idxs):
                wav_h = self._back(self._take(mel, padded)[:, :bucket], pcm16, models)
                _count_frames(mel_len_h[padded[:n]], len(padded), bucket)
                for k, i in enumerate(padded[:n]):
                    wavs[i] = wav_h[k, : int(mel_len_h[i]) * hop] if trim else wav_h[k]
        return wavs, mel_len_h

    # -------------------------------------------------------------- helpers
    def _inputs(self, src_seq, puncts, style_embed, num_phonemes):
        """The request's arrays as tensors on the engine's device."""
        return request_tensors(self.cfg, self.device, src_seq, puncts, style_embed,
                               num_phonemes)

    def _take(self, t: torch.Tensor, padded: Sequence[int]) -> torch.Tensor:
        """Rows `padded` of t (t itself where they are all its rows in order)."""
        if list(padded) == list(range(t.shape[0])):
            return t
        return t[torch.as_tensor(padded, device=self.device)]

    def _run_front(self, src_seq, puncts, style_embed, num_phonemes,
                   models: Optional[Tuple[LoadedModel, ...]] = None):
        """Front at ladder sizes; returns (device mel (B, T, mels), host mel_len)."""
        src, pun, sty, nph = self._inputs(src_seq, puncts, style_embed, num_phonemes)
        mels, lens = [], []
        for padded, n in self._ladder_chunks(range(src.shape[0])):
            mel_c, len_c = self._front(*(self._take(a, padded) for a in (src, pun, sty, nph)),
                                       models)
            mels.append(mel_c[:n])
            lens.append(len_c[:n])
        mel = mels[0] if len(mels) == 1 else torch.cat(mels, dim=0)
        return mel, _to_host(torch.cat(lens))

    def _trim(self, wav_h: np.ndarray, mel_len_h: np.ndarray, trim: bool
              ) -> List[np.ndarray]:
        if not trim:
            return [wav_h[i] for i in range(wav_h.shape[0])]
        hop = self.cfg.hop_size
        return [wav_h[i, : int(mel_len_h[i]) * hop] for i in range(wav_h.shape[0])]
