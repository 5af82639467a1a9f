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
package).  TF32 is switched off once per process, where a CUDA device is
resolved (device.full_precision_products), never around a product: the flag
is process-wide, and a save/restore per product races between the threads
of a serving daemon.

bfloat16 (the serving dtype) follows the JAX package's rule for every
product: bf16 operands, f32 accumulation, the result rounded once to bf16,
then the bias added in bf16.  On a card that is cuDNN's / cuBLAS's bf16
path with reduced-precision reductions switched off (once per process, by
device.resolve_device); for a tensor on the
CPU the operands are widened to f32 (every product is then exact) and the
f32 result is rounded, which is the same rule and needs no bf16 CPU kernels.

float64 (the reference that training's gradient checks hold float32
against) is computed in float64, as float32 is in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_OWN_DTYPE = (torch.float32, torch.float64)     # products computed in the operands' dtype


def _product(fn, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """fn(x, w, bias) by the dtype's rule, with x channels-first (B, C, T)
    and the result too.  float32 / float64: one call, bias inside.  Other dtypes: f32
    accumulation, one rounding to x.dtype, then the bias added in x.dtype
    (operands widened for a CPU tensor)."""
    if x.dtype in _OWN_DTYPE:
        return fn(x, w, b)
    if x.device.type == "cpu":
        y = fn(x.to(torch.float32), w.to(torch.float32), None).to(x.dtype)
    else:
        y = fn(x, w, None)
    return y if b is None else y + b[:, None]


def conv1d(x: torch.Tensor,
           w: torch.Tensor,
           b: Optional[torch.Tensor] = None,
           stride: int = 1,
           padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """Conv1d with symmetric zero padding.  x: (B, T, Cin), w: (Cout, Cin, K)."""
    y = _product(lambda x_, w_, b_: F.conv1d(x_, w_, b_, stride=stride, padding=padding,
                                             dilation=dilation),
                 x.transpose(1, 2), w, b)
    return y.transpose(1, 2)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T + b with w: (out, in)."""
    if x.dtype in _OWN_DTYPE:
        return F.linear(x, w, b)
    y = matmul(x, w.t())
    return y if b is None else y + b


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b by the dtype's rule (see the module docstring)."""
    if a.dtype in _OWN_DTYPE or a.device.type != "cpu":
        return torch.matmul(a, b)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


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
    y = _product(lambda x_, w_, b_: F.conv_transpose1d(x_, w_, b_, stride=stride,
                                                       padding=padding,
                                                       output_padding=output_padding),
                 x.transpose(1, 2), unflip_transpose_weight(w_flipped), b)
    return y.transpose(1, 2)
