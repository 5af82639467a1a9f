"""Training losses (the port of zerovox_tpu/training/losses.py).

FastSpeech2-style losses with teacher forcing, a masked L1 on the mel and a
masked MSE on log durations, plus the multi-resolution STFT loss through
which the HiFi-GAN generator trains.  Each function computes what the JAX
function of the same name computes:

  * the Hann window is the symmetric one (jnp.hanning), not
    torch.hann_window's periodic default;
  * frames are cut by index, hop apart, with no centring or padding (not
    torch.stft's defaults); each frame is zero-padded to fft_size by rfft;
  * the magnitude is sqrt(max(re^2 + im^2, 1e-7)), the clip before the
    root, so below the clip the gradient is 0;
  * the spectral-convergence norms are Frobenius norms over every element.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

STFT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE over positions where mask is True."""
    mask = mask.to(pred.dtype)
    se = (pred - target) ** 2 * mask
    return se.sum() / torch.clamp(mask.sum(), min=1.0)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - target| over the masked positions; a (B, T) mask on
    (B, T, M) values counts each position M times."""
    if mask.dim() < pred.dim():
        mask = mask[..., None]
    mask = mask.to(pred.dtype)
    ae = (pred - target).abs() * mask
    denom = mask.sum() * (pred.shape[-1] if mask.shape[-1] == 1 else 1)
    return ae.sum() / torch.clamp(denom, min=1.0)


def stft_magnitude(x: torch.Tensor, fft_size: int, hop: int, win_length: int) -> torch.Tensor:
    """|STFT| of (B, L) signals with a Hann window -> (B, frames, fft//2+1)."""
    frames = x.unfold(-1, win_length, hop)                 # (B, 1 + (L - win) // hop, win)
    window = torch.hann_window(win_length, periodic=False, dtype=torch.float64)
    spec = torch.fft.rfft(frames * window.to(x.device, x.dtype), n=fft_size, dim=-1)
    return torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-7))


def stft_loss(pred_wav: torch.Tensor, target_wav: torch.Tensor,
              resolutions: Sequence[Tuple[int, int, int]] = STFT_RESOLUTIONS) -> torch.Tensor:
    """Multi-resolution STFT loss: spectral convergence + log-magnitude L1,
    averaged over the resolutions (fft_size, hop, win_length)."""
    total = 0.0
    for fft_size, hop, win in resolutions:
        p = stft_magnitude(pred_wav, fft_size, hop, win)
        t = stft_magnitude(target_wav, fft_size, hop, win)
        sc = torch.linalg.norm(t - p) / torch.clamp(torch.linalg.norm(t), min=1e-7)
        mag = (torch.log(t) - torch.log(p)).abs().mean()
        total = total + sc + mag
    return total / len(resolutions)


def tts_losses(mel_pred, mel_target, mel_mask, log_dur_pred, dur_target, phoneme_mask,
               wav_pred=None, wav_target=None, stft_resolutions=None) -> Dict[str, torch.Tensor]:
    """Loss dict {"mel_l1", "duration_mse"[, "stft"], "total"}.  dur_target
    is in frames, compared in log space against the predictor's log(d + 1)
    parameterisation."""
    log_dur_target = torch.log(dur_target.to(torch.float32) + 1.0)
    out = {
        "mel_l1": masked_l1(mel_pred, mel_target, mel_mask),
        "duration_mse": masked_mse(log_dur_pred, log_dur_target, phoneme_mask),
    }
    if wav_pred is not None and wav_target is not None:
        kw = {} if stft_resolutions is None else {"resolutions": stft_resolutions}
        out["stft"] = stft_loss(wav_pred, wav_target, **kw)
    out["total"] = sum(out.values())
    return out
