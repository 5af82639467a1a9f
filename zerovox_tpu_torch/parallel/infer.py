"""Sharded batched inference over a (data, model) mesh.

The port of zerovox_tpu/parallel/infer.py.  Three regimes, chosen by the
mesh shape:

- **Pure DP** (model == 1): each data device runs the whole local
  `synthesize` on its slice of the batch, with the MRF kernel, and with no
  exchange between devices; the results are gathered at the end.
- **TP, time-sharded vocoder** (model > 1, the default where
  `time_shard_geometry` is exact): the encoder and decoder run
  channel-sharded (Megatron pairing, parallel.tp), but the vocoder, most
  of the work and local in time (convs only), is not split by channels:
  each model-axis device vocodes an exact window of the mel (the streaming
  window scheme of models.streaming, clamped into the buffer) on a replica
  of the vocoder weights, through the MRF kernel, and the windows
  concatenate over the model axis into the full waveform.
- **TP, channel-sharded vocoder** (time_shard_vocoder=False, or a geometry
  that is not exact): the wide vocoder convs are split on their output
  channels as the sharding rules say and gathered before the next conv.
  They run through the kernel's plain version: the kernel is not split
  across devices (the JAX package leaves Pallas here for the same reason).
  `cfg.vocoder_backend` selects no path in the port, so the JAX package's
  warning that 'pallas' is overridden here has no counterpart.

Every regime takes its weights as the object array that
make_sharded_synthesize returns (one LoadedModel per device: its shard of
the tree, and, where it holds the whole vocoder, the kernel's packed
weights) and returns one SynthesisResult whose tensors lie on the mesh's
first device.  Launches go through each device's issuing thread
(device.on_issuing_thread); the caller's thread only waits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import submit_on_issuing_thread
from ..models import hifigan
from ..models.pipeline import (LoadedModel, SynthesisResult, cast_params, compute_dtype,
                               front, pack_model)
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh
from .sharding import param_partition_specs, replicated_specs, shard_batch, shard_params
from .tp import front_tp, tp_view, vocode_tp


def time_shard_geometry(cfg: ZeroVoxConfig, n_model: int):
    """(chunk, overlap, window) for the exact time-sharded vocoder, or None.

    Every window edge either carries >= overlap frames of real mel context
    (the vocoder receptive field fits inside, so the emitted region matches
    the full run — models/streaming.py proves the scheme) or coincides with
    a true buffer edge.  Needs max_seq_len % n_model == 0 and a window that
    still fits in the buffer.
    """
    T = cfg.max_seq_len
    if n_model <= 1 or T % n_model:
        return None
    ch = T // n_model
    ov = 2 * hifigan.receptive_field_frames(cfg)   # 2x safety, cf. streaming
    W = ch + 2 * ov
    if W > T:
        W = T
    return ch, ov, W


def load_sharded(params: dict, cfg: ZeroVoxConfig, mesh: Mesh, specs, pack: bool
                 ) -> np.ndarray:
    """shard_params as LoadedModels: per device its shard of the tree, in
    cfg.compute_dtype, with the kernel's packed vocoder weights where `pack`
    (the device holds the whole vocoder).  A device the mesh repeats holds
    one copy per model-axis position."""
    trees = shard_params(params, mesh, specs)
    out = np.empty(mesh.devices.shape, dtype=object)
    made = {}
    for (i, k), dev in np.ndenumerate(mesh.devices):
        if id(trees[i, k]) not in made:
            tree = trees[i, k]
            if cfg.compute_dtype == "bfloat16":
                tree = cast_params(tree, torch.bfloat16)
            made[id(trees[i, k])] = (pack_model(tree, cfg, dev) if pack
                                     else LoadedModel(tree, None, dev))
        out[i, k] = made[id(trees[i, k])]
    return out


def make_sharded_synthesize(cfg: ZeroVoxConfig, mesh: Mesh, params,
                            use_tp: Optional[bool] = None,
                            time_shard_vocoder: Optional[bool] = None):
    """Returns (sharded_params, step_fn(sharded_params, src, puncts, style,
    num_phonemes=None)).

    The batch rides the "data" axis (its size must split evenly over it).
    With use_tp (default: when the mesh has a model axis > 1) the encoder
    and decoder weights are channel-sharded; time_shard_vocoder (default:
    on where the window geometry is exact) vocodes time windows per
    model-axis device so the MRF kernel survives TP."""
    n_model = mesh.shape.get(MODEL_AXIS, 1)
    if use_tp is None:
        use_tp = n_model > 1

    if not use_tp:
        models = load_sharded(params, cfg, mesh, replicated_specs(params), pack=True)
        return models, _with_default_n(cfg, mesh, _dp_step(cfg))

    geom = time_shard_geometry(cfg, n_model)
    if time_shard_vocoder is None:
        time_shard_vocoder = geom is not None
    specs = param_partition_specs(params)
    if time_shard_vocoder:
        if geom is None:
            raise ValueError(
                "time_shard_vocoder requires max_seq_len divisible by the "
                f"model axis ({cfg.max_seq_len} % {n_model} != 0)")
        specs["vocoder"] = replicated_specs(params["vocoder"])
        models = load_sharded(params, cfg, mesh, specs, pack=True)
        return models, _with_default_n(cfg, mesh, _tp_step(cfg, specs, geom))
    models = load_sharded(params, cfg, mesh, specs, pack=False)
    return models, _with_default_n(cfg, mesh, _tp_step(cfg, specs, None))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _rows(x, mesh: Mesh, dtype):
    """x (a whole batch, or shard_batch's row blocks) as one block per data
    row, each on the row's first device, in `dtype`."""
    if not (isinstance(x, list) and len(x) == mesh.shape[DATA_AXIS]
            and all(isinstance(t, torch.Tensor) for t in x)):
        x = shard_batch(_as_tensor(x), mesh)
    return [t.to(dev, dtype) for t, dev in zip(x, mesh.devices[:, 0])]


def _with_default_n(cfg: ZeroVoxConfig, mesh: Mesh, step):
    """num_phonemes=None -> full-length counts; every input split into the
    data rows, then step(models, rows) gathered on the mesh's first device."""
    lead = mesh.devices[0, 0]

    def fn(models, src, pun, style, n=None):
        src_r = _rows(src, mesh, torch.long)
        if n is None:
            n_r = [torch.full((s.shape[0],), s.shape[1], dtype=torch.long, device=s.device)
                   for s in src_r]
        else:
            if not (isinstance(n, list) and all(isinstance(t, torch.Tensor) for t in n)):
                n = _as_tensor(n)
                if n.dim() == 0:
                    n = n.expand(sum(s.shape[0] for s in src_r))
            n_r = _rows(n, mesh, torch.long)
        rows = list(zip(src_r, _rows(pun, mesh, torch.long), _rows(style, mesh, torch.float32),
                        n_r))
        results = step(models, rows)
        return SynthesisResult(*(torch.cat([getattr(r, f).to(lead) for r in results])
                                 for f in SynthesisResult._fields))

    return fn


def _local(cfg: ZeroVoxConfig, model: LoadedModel, src, pun, style, n) -> SynthesisResult:
    """The whole local pipeline on one device's slice (the MRF kernel on a
    card)."""
    with torch.inference_mode():
        mel, mel_len, log_dur = front(model.params, cfg, src, pun,
                                      style.to(compute_dtype(cfg)), n)
        wav = hifigan.vocode(model.params, cfg, mel, model.packed)
    return SynthesisResult(wav=wav, mel=mel, mel_len=mel_len, log_duration=log_dur)


def _dp_step(cfg: ZeroVoxConfig):
    def step(models, rows):
        futures = [submit_on_issuing_thread(models[i, 0].device, _local, cfg, models[i, 0], *row)
                   for i, row in enumerate(rows)]
        return [f.result() for f in futures]

    return step


def _tp_step(cfg: ZeroVoxConfig, specs, geom):
    """One data row per TP group: the channel-sharded front on the row's
    first device, then either one exact window per model-axis device (geom)
    or the channel-sharded plain vocoder."""
    T, hop = cfg.max_seq_len, cfg.hop_size

    @torch.inference_mode()
    def row_front(row_models, src, pun, style, n):
        view = tp_view([m.params for m in row_models], specs)
        mel, mel_len, log_dur = front_tp(view, cfg, src, pun, style.to(compute_dtype(cfg)), n)
        wav = None if geom else vocode_tp(view, cfg, mel)
        return mel, mel_len, log_dur, wav

    @torch.inference_mode()
    def window(model: LoadedModel, mel: torch.Tensor, k: int) -> torch.Tensor:
        ch, ov, W = geom
        start = k * ch
        ws = min(max(start - ov, 0), T - W)
        wav = hifigan.vocode(model.params, cfg, mel[:, ws:ws + W].to(model.device),
                             model.packed)
        return wav[:, (start - ws) * hop:(start - ws + ch) * hop]

    def step(models, rows):
        fronts = [submit_on_issuing_thread(models[i, 0].device, row_front, models[i], *row)
                  for i, row in enumerate(rows)]
        fronts = [f.result() for f in fronts]
        if geom:
            wins = [[submit_on_issuing_thread(m.device, window, m, f[0], k)
                     for k, m in enumerate(models[i])] for i, f in enumerate(fronts)]
            wavs = [torch.cat([w.result().to(f[0].device) for w in ws], dim=1)
                    for ws, f in zip(wins, fronts)]
        else:
            wavs = [f[3] for f in fronts]
        return [SynthesisResult(wav=wav, mel=mel, mel_len=mel_len, log_duration=log_dur)
                for (mel, mel_len, log_dur, _), wav in zip(fronts, wavs)]

    return step
