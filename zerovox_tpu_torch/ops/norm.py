"""Normalisation ops with ggml-exact semantics, on channels-last (B, T, C).

LayerNorm reduces the channel axis (-1); InstanceNorm1d reduces **time**
(axis -2), per channel, as the reference's ggml_norm-over-time construction
does.  Moments are f32, variance without Bessel's correction.  A float32
input takes them in two passes (mean, then the mean of squared deviations:
no catastrophic cancellation; the parity path); any other dtype (the bf16
serving path) in one pass, E[x^2] - E[x]^2 clamped at 0, as the JAX
package does, so that both compute the same thing.  A float64 input (the
reference that training's gradient checks hold float32 against) takes two
passes in float64.
"""

from __future__ import annotations

from typing import Optional

import torch


def _normalize(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.float64):
        xf = x.to(torch.float32)
        n = x.shape[dim]
        mean = xf.sum(dim=dim, keepdim=True) / n
        var = torch.clamp((xf * xf).sum(dim=dim, keepdim=True) / n - mean * mean, min=0.0)
        return ((xf - mean) * (1.0 / torch.sqrt(var + eps))).to(x.dtype)
    mean = x.mean(dim=dim, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=dim, keepdim=True)
    return centered * (1.0 / torch.sqrt(var + eps))


def _affine(out, gamma, beta):
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


def layer_norm(x: torch.Tensor,
               gamma: Optional[torch.Tensor] = None,
               beta: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel (last) axis.  gamma/beta: (C,)."""
    return _affine(_normalize(x, -1, eps), gamma, beta)


def instance_norm(x: torch.Tensor,
                  gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d over the time axis of (B, T, C) (or (T, C)) activations,
    with an optional per-channel affine (C,)."""
    return _affine(_normalize(x, -2, eps), gamma, beta)
