"""Small ops: variance-embedding bucketizer, activations, sinusoid table."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def scalar_as(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float.  The JAX package
    turns a scalar that meets a bf16 array into bf16 first; PyTorch would
    multiply by the unrounded float."""
    return float(torch.tensor(value, dtype=dtype))


def bucketize(prediction: torch.Tensor, n_bins: int) -> torch.Tensor:
    """clamp(floor(prediction * (n_bins-1) + 0.5), 0, n_bins-1) -> int64 indices.

    The reference's `(int32_t)(x*(n_bins-1) + 0.5)` then clamp: round half
    up on the non-negative range; negatives clamp to 0 either way.
    """
    bin_max = n_bins - 1
    x = prediction.to(torch.float32) * bin_max
    return torch.clamp(torch.floor(x + 0.5), 0, bin_max).to(torch.int64)


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * scalar_as(negative_slope, x.dtype))


def sinusoid_encoding_table(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoid position-encoding table, bit-matching the reference exporter."""
    hid = np.arange(d_hid)
    denom = np.power(10000.0, 2 * (hid // 2) / d_hid)
    table = (np.arange(n_position)[:, None] / denom[None, :]).astype(np.float32)
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table
