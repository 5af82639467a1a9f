"""Serving engine: mel-length buckets, batch ladder, batched synthesis on one device.

The engine runs the encoder + length regulator + StyleTTS decoder at the
full max_seq_len (the decoder's InstanceNorms reduce over the whole padded
time axis, so they must see the same padded buffer as the reference), reads
the predicted mel lengths, and runs only the heavy vocoder at the smallest
bucket that covers mel_len plus the vocoder's receptive field, so the
trimmed audio equals the full-length run's.

Batches are split at the top of the batch ladder, as in the JAX package,
so that the ladder top bounds the memory of one dispatch.  The front runs
each chunk padded (first row repeated) to the smallest ladder size that
holds it.  The vocoder runs each row at its own bucket: a call's rows are
grouped by bucket across its chunks, and each group is vocoded at its real
rows (with a mesh, rounded up to a whole row per data device) in ladder-top
chunks, since a padded row or frame costs it as much as a real one.  So the
shapes a serving process runs are the fronts at len(batch_ladder) sizes and
the vocoder at every row count up to the ladder top, each at every mel
bucket; warmup() runs each once.

Multi-device serving: pass `mesh=` (a pure-DP parallel.Mesh, model axis 1)
and every front and vocoder call is split over the mesh's data devices,
each running the complete local pipeline (the MRF kernel included) on its
slice of the batch, on its own replica of the model and its own issuing
thread, with no exchange between devices; the slices are gathered on the
mesh's first device.  The batch ladder scales by the data size so that
every call splits evenly.  Tensor-parallel serving is
runtime.tp_engine.TPServingEngine.

The engine records (utils.profiling) its launches on the issuing thread
("issue.front"; "issue.vocode" inside "issue.collect"), the calling
thread's waits for the card ("engine.sync"), for each vocoder call a
"vocoder.frames" counter (the frames its real rows need and the frames it
vocodes) and for each engine call a "vocoder.groups" counter (the vocoder
calls it made and the ladder chunks its fronts ran in).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

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


def _wait_host(pending) -> np.ndarray:
    """A to_host_async() copy on the host: the calling thread waits for the
    card ("engine.sync")."""
    with profiling.span("engine.sync"):
        return wait_host(pending).numpy()


def _count_frames(mel_len: np.ndarray, rows: int, bucket: int):
    """The "vocoder.frames" counter of one vocoder call: the frames its real
    rows need (their mel lengths) and the frames it vocodes (every row it
    runs, a mesh's padding row included, at the bucket's length)."""
    profiling.count("vocoder.frames", int(np.sum(mel_len)), rows * bucket)


class _Rows(NamedTuple):
    """Rows `rows` of a call's issued mels (`mels`, one tensor per ladder
    chunk), cut to `bucket` frames: what one vocoder call runs on."""
    mels: Tuple[torch.Tensor, ...]
    rows: List[int]
    bucket: int

    def split(self, n: int) -> List["_Rows"]:
        """These rows in n even slices (_vocode_rows makes them a whole
        number per data device)."""
        k = len(self.rows) // n
        return [self._replace(rows=self.rows[i * k:(i + 1) * k]) for i in range(n)]


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
    def _split(self, span: str, issue, models: Tuple[LoadedModel, ...], *args, **kw):
        """issue(*args, model, **kw) on the issuing thread of each model's
        device (device.on_issuing_thread; recorded as the span `span`),
        whatever thread calls: on the whole batch with one device, else on
        each data device's slice of the rows, the outputs gathered on the
        engine's device.  A tensor of args is split on the calling thread
        and copied to each device; a _Rows is split by its rows, and issue
        selects them on its own thread.  No host sync."""
        if len(models) == 1:
            return on_issuing_thread(models[0].device, issue, *args, models[0], span=span, **kw)
        parts = [a.split(len(models)) if isinstance(a, _Rows)
                 else [p.to(m.device) for p, m in zip(a.tensor_split(len(models)), models)]
                 for a in args]
        # the first device's slice last: from its issuing thread (_collect)
        # that slice runs inline, so the other devices' are queued before it
        futures = {i: submit_on_issuing_thread(m.device, issue, *(p[i] for p in parts), m,
                                               span=span, **kw)
                   for i, m in reversed(list(enumerate(models)))}
        outs = [futures[i].result() for i in range(len(models))]
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

    def _vocode(self, sel: _Rows, pcm16: bool,
                models: Optional[Tuple[LoadedModel, ...]] = None) -> torch.Tensor:
        """Vocoder on the rows `sel` names, left on the device: int16 with
        pcm16 (quantised there, so the host fetch moves half the bytes),
        else float32 (a bf16 waveform is widened for the caller).  Issued as
        _front, the rows' selection with it on the issuing thread."""
        return self._split("issue.vocode", self._issue_vocode, models or self._models, sel,
                           pcm16=(pcm16,))

    @torch.inference_mode()
    def _issue_vocode(self, sel: _Rows, model: LoadedModel, pcm16=(False,)):
        """One vocode, returned once per entry of pcm16 (warmup asks for
        both forms)."""
        mel_b = self._mel_rows(sel.mels, sel.rows)[:, :sel.bucket].to(model.device)
        wav = hifigan.vocode(model.params, self.cfg, mel_b, model.packed)
        outs = tuple(float_to_pcm16_device(wav) if p else wav.to(torch.float32) for p in pcm16)
        return outs if len(outs) > 1 else outs[0]

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

    def _vocode_rows(self, n: int) -> int:
        """The rows the vocoder runs for a chunk of n real rows: n, rounded up
        to a whole row per data device."""
        d = len(self._models)
        return -(-n // d) * d

    def _ladder_chunks(self, idxs: Sequence[int], rows_for=None):
        """Split an index list into ladder-top chunks, each padded (first
        index repeated) up to rows_for(n) rows, n its real rows (default:
        the ladder size, the front's rows).  Yields (padded_idxs, n_real)."""
        top = self.batch_ladder[-1]
        for c0 in range(0, len(idxs), top):
            chunk = list(idxs[c0:c0 + top])
            rows = (rows_for or self.ladder_size)(len(chunk))
            yield chunk + [chunk[0]] * (rows - len(chunk)), len(chunk)

    def row_ladder_sizes(self, n: int) -> List[int]:
        """The batch size each row of an n-row call is computed at: the
        ladder size its chunk's front is padded to.  In bfloat16 an answer
        can depend on it; the DynamicBatcher reports it per request."""
        return [len(padded) for padded, k in self._ladder_chunks(range(n)) for _ in range(k)]

    def group_by_bucket(self, predicted_lens: Sequence[int]) -> Dict[int, List[int]]:
        """Group utterance indices by their mel bucket (for batch packing)."""
        groups: Dict[int, List[int]] = {}
        for i, L in enumerate(predicted_lens):
            groups.setdefault(self.pick_bucket(int(L)), []).append(i)
        return groups

    def warmup(self, batch: int = 1, pcm16: bool = False):
        """Run every shape serving can hit for batches up to `batch` once:
        the front at every ladder size <= ladder_size(batch), and the
        vocoder at each bucket at every row count it runs for them
        (_vocode_rows), its output float32 and with pcm16 also int16.  On a
        card this builds the MRF kernel and lets cuDNN pick its algorithms
        before the first request."""
        cfg = self.cfg
        for s in (s for s in self.batch_ladder if s <= self.ladder_size(batch)):
            src = torch.zeros((s, cfg.max_n_phonemes), dtype=torch.long,
                              device=self.device)
            style = torch.zeros((s, cfg.d_model), device=self.device)
            nph = torch.zeros((s,), dtype=torch.long, device=self.device)
            mel, _ = self._front(src, src, style, nph)
            rows = sorted({self._vocode_rows(n) for n in range(1, s + 1)
                           if self.ladder_size(n) == s})
            for b in self.mel_buckets:
                for r in rows:
                    self._split("issue.vocode", self._issue_vocode, self._models,
                                _Rows((mel,), list(range(r)), b),
                                pcm16=(False, True) if pcm16 else (False,))
        for dev in dict.fromkeys(self._devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------ API
    def synthesize(self, src_seq, puncts, style_embed, num_phonemes=None,
                   trim: bool = True, pcm16: bool = False
                   ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Batched synthesis: synthesize_async(...)().

        Returns (per-utterance waveforms, trimmed to mel_len*hop when
        trim=True, else the full padded buffer; mel_len array)."""
        return self.synthesize_async(src_seq, puncts, style_embed, num_phonemes=num_phonemes,
                                     trim=trim, pcm16=pcm16)()

    def synthesize_async(self, src_seq, puncts, style_embed, num_phonemes=None,
                         trim: bool = True, pcm16: bool = False
                         ) -> Callable[[], Tuple[List[np.ndarray], np.ndarray]]:
        """Launch synthesis without waiting for the device; returns a
        fetch() closure that finishes it.

        The fronts are launched with no host sync; fetch() vocodes the rows
        of each bucket together across the call's ladder chunks, each group
        at its bucket (trim=False: every row at the largest bucket), so that
        short utterances do not pay for the longest one's frames, and waits
        for the waveforms.  A DynamicBatcher dispatch is one such call: one
        vocoder call per bucket its rows reach.  The calling thread never
        waits for the device, so a caller can launch batch k+1 while batch k
        is still computing or being fetched on another thread."""
        issued = self._issue_fronts(src_seq, puncts, style_embed, num_phonemes)
        return lambda: self._collect(*issued, trim, pcm16)

    def synthesize_packed(self, src_seq, puncts, style_embed,
                          num_phonemes=None, trim: bool = True,
                          pcm16: bool = False
                          ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Bucket-packed batched synthesis (/batch, long-form): synthesize()
        under the name the JAX engine gives it."""
        return self.synthesize(src_seq, puncts, style_embed, num_phonemes=num_phonemes,
                               trim=trim, pcm16=pcm16)

    # -------------------------------------------------------------- helpers
    def _inputs(self, src_seq, puncts, style_embed, num_phonemes):
        """The request's arrays as tensors on the engine's device."""
        return request_tensors(self.cfg, self.device, src_seq, puncts, style_embed,
                               num_phonemes)

    def _take(self, t: torch.Tensor, padded: Sequence[int]) -> torch.Tensor:
        """Rows `padded` of t (a view where they are its first rows in order)."""
        if list(padded) == list(range(len(padded))):
            return t[:len(padded)]
        return t[torch.as_tensor(padded, device=self.device)]

    def _issue_fronts(self, src_seq, puncts, style_embed, num_phonemes):
        """Issue a call's fronts, ladder chunk by ladder chunk, each padded to
        its ladder size, and behind each its mel_len's copy into pinned host
        memory; no host sync.  Returns the models in use (the vocoder runs on
        them too, whatever reload_params does meanwhile) and per chunk
        (mel, pending mel_len, real rows)."""
        models = self._models
        src, pun, sty, nph = self._inputs(src_seq, puncts, style_embed, num_phonemes)
        fronts = []
        for padded, n in self._ladder_chunks(range(src.shape[0])):
            mel, mel_len = self._front(*(self._take(a, padded) for a in (src, pun, sty, nph)),
                                       models)
            fronts.append((mel, to_host_async(mel_len), n))
        return models, fronts

    def _collect(self, models, fronts, trim: bool, pcm16: bool
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Finish a call whose fronts were issued: wait for mel_len; vocode
        each bucket's rows (group_by_bucket; trim=False: all rows at the
        largest bucket, for the full padded buffer it promises) at that
        bucket, in ladder-top chunks of their real rows (_vocode_rows), each
        waveform's copy into pinned host memory started behind it, all in
        one run of the issuing thread (span "issue.collect"), so that no
        other call's front is issued between them; then wait for the copies
        and trim."""
        mel_len = np.concatenate([_wait_host(len_p)[:n] for _, len_p, n in fronts])
        groups = (self.group_by_bucket(mel_len) if trim
                  else {self.mel_buckets[-1]: list(range(len(mel_len)))})
        mels = tuple(mel for mel, _, _ in fronts)
        calls = [(_Rows(mels, padded, bucket), padded[:n]) for bucket, rows in groups.items()
                 for padded, n in self._ladder_chunks(rows, self._vocode_rows)]
        copies = on_issuing_thread(
            models[0].device, lambda: [to_host_async(self._vocode(sel, pcm16, models))
                                       for sel, _ in calls], span="issue.collect")
        for sel, rows in calls:
            _count_frames(mel_len[rows], len(sel.rows), sel.bucket)
        profiling.count("vocoder.groups", len(calls), len(fronts))
        wavs: List[Optional[np.ndarray]] = [None] * len(mel_len)
        for (_, rows), wav_p in zip(calls, copies):
            for i, w in zip(rows, self._trim(_wait_host(wav_p)[:len(rows)], mel_len[rows], trim)):
                wavs[i] = w
        return wavs, mel_len

    def _mel_rows(self, mels: Sequence[torch.Tensor], rows: Sequence[int]) -> torch.Tensor:
        """The issued mels at rows `rows` of the call, whose ladder chunk c
        holds rows c * top onward (_ladder_chunks): one view per run of
        consecutive rows of one chunk, concatenated where there are several,
        so a selection copies nothing from the host; one run stays a view."""
        top = self.batch_ladder[-1]
        runs: List[List[int]] = []            # [chunk, first row, end]
        for r in rows:
            c, i = divmod(r, top)
            if runs and runs[-1][0] == c and runs[-1][2] == i:
                runs[-1][2] += 1
            else:
                runs.append([c, i, i + 1])
        views = [mels[c][i:j] for c, i, j in runs]
        return views[0] if len(views) == 1 else torch.cat(views)

    def _trim(self, wav_h: np.ndarray, mel_len_h: np.ndarray, trim: bool
              ) -> List[np.ndarray]:
        if not trim:
            return [wav_h[i] for i in range(wav_h.shape[0])]
        hop = self.cfg.hop_size
        return [wav_h[i, : int(mel_len_h[i]) * hop] for i in range(wav_h.shape[0])]
