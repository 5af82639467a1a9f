"""End-to-end synthesis: phonemes -> waveform.

encoder -> length regulator -> decoder -> vocoder, eagerly on one device;
intermediates stay on that device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import resolve_device
from ..ops import durations_from_log, length_regulate
from ..params import params_to_device, tree_map
from . import fs2_encoder, hifigan, styletts_decoder


class SynthesisResult(NamedTuple):
    wav: torch.Tensor            # (B, max_seq_len * hop_size)
    mel: torch.Tensor            # (B, max_seq_len, num_mels)
    mel_len: torch.Tensor        # (B,) valid mel frames
    log_duration: torch.Tensor   # (B, P)


def synthesize(params: dict, cfg: ZeroVoxConfig,
               src_seq, puncts, style_embed,
               num_phonemes=None, device="cuda") -> SynthesisResult:
    """Full pipeline on batched inputs (tensors or numpy arrays).

    src_seq / puncts: (B, P) ids padded to max_n_phonemes
    style_embed:      (B, d_model) float
    num_phonemes:     optional (B,) valid counts (default P, as the reference)
    device:           where it runs; params must already lie there
                      (load_params / init_params / params_to_device)

    cfg.compute_dtype "bfloat16" is the serving dtype: the style embedding
    is cast to it here, and params must have been cast with cast_params
    (TTSEngine(precision="bfloat16") does both).
    """
    dev = resolve_device(device)
    src_seq = torch.as_tensor(src_seq, device=dev).long()
    puncts = torch.as_tensor(puncts, device=dev).long()
    style_embed = torch.as_tensor(style_embed, device=dev,
                                  dtype=torch.float32).to(compute_dtype(cfg))
    if num_phonemes is not None:
        num_phonemes = torch.as_tensor(num_phonemes, device=dev).long()
    mel, mel_len, log_dur = front(params, cfg, src_seq, puncts, style_embed, num_phonemes)
    wav = hifigan.vocode(params, cfg, mel)
    return SynthesisResult(wav=wav, mel=mel, mel_len=mel_len, log_duration=log_dur)


def front(params: dict, cfg: ZeroVoxConfig, src_seq: torch.Tensor, puncts: torch.Tensor,
          style_embed: torch.Tensor, num_phonemes: Optional[torch.Tensor]):
    """Everything before the vocoder, on device tensors, with no host sync:
    encoder, length regulator and decoder at the full max_seq_len (the
    decoder's instance norms reduce over the whole padded time axis).
    Returns (mel (B, max_seq_len, num_mels), mel_len (B,), log_duration)."""
    mask = None
    if cfg.use_attention_mask and num_phonemes is not None:
        mask = fs2_encoder.phoneme_mask(num_phonemes, src_seq.shape[-1])
    features, log_dur = fs2_encoder.encode(params, cfg, src_seq, puncts,
                                           style_embed, phoneme_mask=mask)
    durations = durations_from_log(log_dur, cfg.max_seq_len)
    hidden, mel_len = length_regulate(features, durations, cfg.max_seq_len,
                                      num_phonemes=num_phonemes)
    mel = styletts_decoder.decode(params, cfg, hidden, style_embed)
    return mel, mel_len, log_dur


def request_tensors(cfg: ZeroVoxConfig, device: torch.device, src_seq, puncts, style_embed,
                    num_phonemes=None):
    """A serving request's arrays as tensors on `device`: (src, puncts,
    float32 style, num_phonemes; max_n_phonemes for every row when omitted)."""
    src = torch.as_tensor(np.asarray(src_seq), device=device).long()
    pun = torch.as_tensor(np.asarray(puncts), device=device).long()
    sty = torch.as_tensor(np.asarray(style_embed, np.float32), device=device)
    if src.shape[0] == 0:
        raise ValueError("empty batch")
    nph = (torch.full((src.shape[0],), cfg.max_n_phonemes, device=device)
           if num_phonemes is None
           else torch.as_tensor(np.asarray(num_phonemes), device=device).long())
    return src, pun, sty, nph


class LoadedModel(NamedTuple):
    """What a serving call reads once at its start: the weights and the
    same weights in the MRF kernel's layout.  The two are replaced together,
    as one reference, so a call in flight never mixes old and new."""
    params: dict
    packed: Optional[List]      # hifigan.pack_vocoder on a card, None on the CPU
    device: torch.device        # where both lie (and whose issuing thread runs them)


def place_params(params: dict, cfg: ZeroVoxConfig, device: torch.device) -> dict:
    """params on `device` and in cfg.compute_dtype (bfloat16: cast once, here)."""
    params = params_to_device(params, device)
    if cfg.compute_dtype == "bfloat16":
        params = cast_params(params, torch.bfloat16)
    return params


def pack_model(placed: dict, cfg: ZeroVoxConfig, device: torch.device) -> LoadedModel:
    """Params that place_params has placed, with the MRF kernel's weight
    layout made once (the CPU path does not read it)."""
    packed = hifigan.pack_vocoder(placed, cfg) if device.type == "cuda" else None
    return LoadedModel(placed, packed, device)


def load_model(params, cfg: ZeroVoxConfig, device: torch.device) -> LoadedModel:
    """place_params, then pack_model.  A LoadedModel comes back as it is
    (it was placed, cast and packed by whoever made it): that is how a
    daemon's streaming synthesizer shares its engine's weights, held once.
    A LoadedModel on another device is copied there (replicate_model)."""
    if isinstance(params, LoadedModel):
        return replicate_model(params, cfg, device)
    return pack_model(place_params(params, cfg, device), cfg, device)


def replicate_model(model: LoadedModel, cfg: ZeroVoxConfig, device: torch.device) -> LoadedModel:
    """`model` itself where it lies on `device`, else its weights copied
    there and packed anew: a replica for another device of a mesh."""
    if model.device == device:
        return model
    return pack_model(place_params(model.params, cfg, device), cfg, device)


def compute_dtype(cfg: ZeroVoxConfig) -> torch.dtype:
    """The activation dtype cfg.compute_dtype names."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}") from None


def cast_params(params: dict, dtype) -> dict:
    """Cast all floating-point leaves (weights) to `dtype`."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, params)
