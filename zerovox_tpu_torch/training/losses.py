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
    parameterisation.  It is losses_from_sums of the whole batch's sums: the
    values masked_l1, masked_mse and stft_loss give."""
    return losses_from_sums(loss_sums(mel_pred, mel_target, mel_mask, log_dur_pred, dur_target,
                                      phoneme_mask, wav_pred, wav_target, stft_resolutions))


# --------------------------------------------------------------------------
# the losses from sums: a batch split over devices or processes adds its parts'
# --------------------------------------------------------------------------

def loss_sums(mel_pred, mel_target, mel_mask, log_dur_pred, dur_target, phoneme_mask,
              wav_pred=None, wav_target=None, stft_resolutions=None) -> torch.Tensor:
    """The sums tts_losses divides, over this part of a batch, as one vector:
    [mel |d| sum, mel count, duration squared-error sum, duration count],
    then per STFT resolution [sum (t - p)^2, sum t^2, sum |log t - log p|,
    magnitude count], in float32 (float64 for a float64 forward).  Sums over
    the parts of a batch, added in any order,
    give losses_from_sums the whole batch's losses: the masked means divide
    by the whole batch's counts, and the spectral convergence is a norm over
    the whole batch (it is not a mean of per-row terms)."""
    if mel_mask.dim() < mel_pred.dim():
        mel_mask = mel_mask[..., None]
    m = mel_mask.to(mel_pred.dtype)
    mel_cnt = m.sum() * (mel_pred.shape[-1] if m.shape[-1] == 1 else 1)
    p = phoneme_mask.to(log_dur_pred.dtype)
    log_dur_target = torch.log(dur_target.to(torch.float32) + 1.0)
    out = [((mel_pred - mel_target).abs() * m).sum(), mel_cnt,
           ((log_dur_pred - log_dur_target) ** 2 * p).sum(), p.sum()]
    if wav_pred is not None and wav_target is not None:
        for fft_size, hop, win in stft_resolutions or STFT_RESOLUTIONS:
            mp = stft_magnitude(wav_pred, fft_size, hop, win)
            mt = stft_magnitude(wav_target, fft_size, hop, win)
            out += [((mt - mp) ** 2).sum(), (mt ** 2).sum(),
                    (torch.log(mt) - torch.log(mp)).abs().sum(),
                    torch.tensor(float(mt.numel()), device=mt.device)]
    acc = torch.float64 if mel_pred.dtype == torch.float64 else torch.float32
    return torch.stack([o.to(acc) for o in out])


def losses_from_sums(sums: torch.Tensor) -> Dict[str, torch.Tensor]:
    """tts_losses' dict from loss_sums' vector (summed over the batch's
    parts): the same divisions, clamps and square roots, made once."""
    out = {"mel_l1": sums[0] / torch.clamp(sums[1], min=1.0),
           "duration_mse": sums[2] / torch.clamp(sums[3], min=1.0)}
    n_res = (sums.shape[0] - 4) // 4
    if n_res:
        total = 0.0
        for r in range(n_res):
            sq_d, sq_t, abs_log, n = sums[4 + 4 * r:8 + 4 * r]
            sc = torch.sqrt(sq_d) / torch.clamp(torch.sqrt(sq_t), min=1e-7)
            total = total + sc + abs_log / n
        out["stft"] = total / n_res
    out["total"] = sum(out.values())
    return out
