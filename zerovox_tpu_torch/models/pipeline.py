"""End-to-end synthesis: phonemes -> waveform.

encoder -> length regulator -> decoder -> vocoder, eagerly on one device;
intermediates stay on that device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ZeroVoxConfig
from ..device import resolve_device
from ..ops import durations_from_log, length_regulate
from ..params import tree_map
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
    """
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "compute_dtype='bfloat16' is the bf16 serving path, a later slice "
            "of the port; this slice runs float32")
    dev = resolve_device(device)
    src_seq = torch.as_tensor(src_seq, device=dev).long()
    puncts = torch.as_tensor(puncts, device=dev).long()
    style_embed = torch.as_tensor(style_embed, device=dev, dtype=torch.float32)
    if num_phonemes is not None:
        num_phonemes = torch.as_tensor(num_phonemes, device=dev).long()

    mask = None
    if cfg.use_attention_mask and num_phonemes is not None:
        mask = fs2_encoder.phoneme_mask(num_phonemes, src_seq.shape[-1])
    features, log_dur = fs2_encoder.encode(params, cfg, src_seq, puncts,
                                           style_embed, phoneme_mask=mask)
    durations = durations_from_log(log_dur, cfg.max_seq_len)
    hidden, mel_len = length_regulate(features, durations, cfg.max_seq_len,
                                      num_phonemes=num_phonemes)
    mel = styletts_decoder.decode(params, cfg, hidden, style_embed)
    wav = hifigan.vocode(params, cfg, mel)
    return SynthesisResult(wav=wav, mel=mel, mel_len=mel_len, log_duration=log_dur)


def cast_params(params: dict, dtype) -> dict:
    """Cast all floating-point leaves (weights) to `dtype`."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, params)
