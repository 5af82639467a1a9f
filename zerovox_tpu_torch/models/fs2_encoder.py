"""FastSpeech2 phoneme encoder + variance adaptor.

  word-emb + punct-emb lookup, concatenated to d_model
  + sinusoid positional table rows [0, P)
  N x FFTBlock (maskless MHA + conv-FFN)
  + style embedding broadcast
  duration predictor -> log durations
  pitch predictor -> bucketize -> pitch-emb lookup, added
  energy predictor (on the pitch-updated features) -> bucketize, added
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import ZeroVoxConfig
from ..ops import bucketize, conv1d, layer_norm, linear, multi_head_attention
from ..utils.debug import tap


def fft_block(x: torch.Tensor, p: dict, cfg: ZeroVoxConfig,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FFT block: self-attention + position-wise conv feed-forward."""
    x = multi_head_attention(x, p["attn"], cfg.encoder_head, mask=mask,
                             eps=cfg.layer_norm_eps)
    residual = x
    f = p["ffn"]
    k0, k1 = cfg.conv_kernel_size
    h = conv1d(x, f["w1"], f["b1"], padding=(k0 - 1) // 2)
    h = torch.relu(h)
    h = conv1d(h, f["w2"], f["b2"], padding=(k1 - 1) // 2)
    return layer_norm(h + residual, f["ln_g"], f["ln_b"], eps=cfg.layer_norm_eps)


def variance_predictor(x: torch.Tensor, p: dict, cfg: ZeroVoxConfig) -> torch.Tensor:
    """conv->ReLU->LN->conv->ReLU->LN->linear, squeezed to (B, P)."""
    pad = (cfg.vp_kernel_size - 1) // 2
    h = conv1d(x, p["conv1_w"], p["conv1_b"], padding=pad)
    h = torch.relu(h)
    h = layer_norm(h, p["ln1_g"], p["ln1_b"], eps=cfg.layer_norm_eps)
    h = conv1d(h, p["conv2_w"], p["conv2_b"], padding=pad)
    h = torch.relu(h)
    h = layer_norm(h, p["ln2_g"], p["ln2_b"], eps=cfg.layer_norm_eps)
    return linear(h, p["lin_w"], p["lin_b"])[..., 0]


def phoneme_mask(num_phonemes: torch.Tensor, P: int) -> torch.Tensor:
    """(B,) valid counts -> (B, P) bool mask (True = real phoneme)."""
    num_phonemes = torch.as_tensor(num_phonemes)
    idx = torch.arange(P, device=num_phonemes.device)
    return idx[None, :] < num_phonemes.reshape(-1, 1)


def encode(params: dict, cfg: ZeroVoxConfig,
           src_seq: torch.Tensor, puncts: torch.Tensor,
           style_embed: torch.Tensor,
           phoneme_mask: Optional[torch.Tensor] = None,
           fft=fft_block, predictor=variance_predictor,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phonemes -> (features (B, P, d_model), log_duration (B, P)).

    src_seq/puncts: (B, P) integer ids, style_embed: (B, d_model).
    phoneme_mask: optional (B, P) bool, applied only when
    cfg.use_attention_mask (the reference attends over padding).
    fft / predictor: the FFT block and the variance predictor
    (parallel.tp passes its channel-sharded ones, with a tree of shards).
    """
    enc = params["encoder"]
    src_seq = src_seq.long()
    puncts = puncts.long()
    x = torch.cat([enc["word_emb"][src_seq], enc["punct_emb"][puncts]], dim=-1)
    P = src_seq.shape[-1]
    x = x + enc["pos_table"][:P].to(x.dtype)

    attn_mask = phoneme_mask if cfg.use_attention_mask else None
    for layer in enc["layers"]:
        x = fft(x, layer, cfg, mask=attn_mask)
    tap("encoder_output", x)

    features = x + style_embed[:, None, :].to(x.dtype)

    log_duration = predictor(features, enc["duration_predictor"], cfg)

    pitch = tap("pitch", predictor(features, enc["pitch_predictor"], cfg))
    features = features + enc["pitch_emb"][bucketize(pitch, cfg.ve_n_bins)].to(x.dtype)

    # energy is predicted on the pitch-updated features
    energy = tap("energy", predictor(features, enc["energy_predictor"], cfg))
    features = features + enc["energy_emb"][bucketize(energy, cfg.ve_n_bins)].to(x.dtype)
    tap("features", features)
    tap("log_duration", log_duration)
    return features, log_duration
