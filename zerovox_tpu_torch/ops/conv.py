"""1-D convolution primitives on channels-last (B, T, C) activations.

Plain formulations only: F.conv1d / F.conv_transpose1d / F.linear on the
port's weight layouts (see zerovox_tpu_torch.params):

  conv kernels:       (C_out, C_in, K)            PyTorch's Conv1d layout
  transpose kernels:  (C_out, C_in, K), flipped   the GGUF's export layout
  linear weights:     (out, in)                   PyTorch's Linear layout

The JAX package's folded, grouped and contracted conv forms are TPU layout
devices and have no counterpart here.

On a card the convolutions run in full float32: PyTorch lets cuDNN use
TF32 for float32 convolutions by default, which keeps about three decimal
digits, and the float32 path is the parity path (a TF32 duration or pitch
predictor can flip a bucketize or a rounded duration against the JAX
package).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv1d(x: torch.Tensor,
           w: torch.Tensor,
           b: Optional[torch.Tensor] = None,
           stride: int = 1,
           padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """Conv1d with symmetric zero padding.  x: (B, T, Cin), w: (Cout, Cin, K)."""
    with _no_tf32():
        y = F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=padding,
                     dilation=dilation)
    return y.transpose(1, 2)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T + b with w: (out, in)."""
    return F.linear(x, w, b)


def transpose_out_len(L: int, stride: int, K: int, padding: int,
                      output_padding: int) -> int:
    """ConvTranspose1d output length (torch semantics).  Equals L*stride
    exactly when K == stride + 2*padding - output_padding (the standard
    upsampling geometry with pad = s//2 + s%2, outpad = s%2 <=> K == 2s)."""
    return (L - 1) * stride + K - 2 * padding + output_padding


def unflip_transpose_weight(w_flipped: torch.Tensor) -> torch.Tensor:
    """Flipped (Cout, Cin, K) export layout -> PyTorch's ConvTranspose1d
    weight (Cin, Cout, K)."""
    return w_flipped.flip(-1).transpose(0, 1)


def conv_transpose1d(x: torch.Tensor,
                     w_flipped: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     stride: int = 1,
                     padding: int = 0,
                     output_padding: int = 0) -> torch.Tensor:
    """ConvTranspose1d on the flipped export kernel.  x: (B, L, Cin),
    w_flipped: (Cout, Cin, K); output length transpose_out_len(...)."""
    if output_padding >= max(1, stride):
        raise ValueError(
            f"output_padding ({output_padding}) must be < stride ({stride})")
    with _no_tf32():
        y = F.conv_transpose1d(x.transpose(1, 2), unflip_transpose_weight(w_flipped),
                               b, stride=stride, padding=padding,
                               output_padding=output_padding)
    return y.transpose(1, 2)
