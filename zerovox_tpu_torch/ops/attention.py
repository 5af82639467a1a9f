"""Multi-head self-attention matching the reference FFT-block semantics.

Per-layer Linear Q/K/V, per-head softmax(q k^T / sqrt(d_k)) v, head
concat, output Linear, residual + LayerNorm.  The scores and the softmax
are f32 in every dtype but float64 (f64 there); 1/sqrt(d_k) is rounded to
the activation dtype first and the probabilities are rounded to it before
they meet v, as in the JAX package.  The reference applies no
attention mask over padding; that stays the default, and a masked mode
(-1e9 on padded keys) sits behind `mask`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .conv import linear, matmul
from .misc import scalar_as
from .norm import layer_norm


def multi_head_attention(x: torch.Tensor,
                         p: dict,
                         n_head: int,
                         mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """Self-attention block.  x: (B, T, C); p holds wq/bq/wk/bk/wv/bv/wo/bo/
    ln_g/ln_b with Linear weights in (out, in) layout.

    mask: optional (B, T) bool, True = valid position.
    """
    B, T, C = x.shape
    d_k = C // n_head
    residual = x

    def heads(t):                                   # (B, T, C) -> (B, H, T, d)
        return t.reshape(B, T, n_head, d_k).transpose(1, 2)

    q = heads(linear(x, p["wq"], p["bq"]))
    k = heads(linear(x, p["wk"], p["bk"]))
    v = heads(linear(x, p["wv"], p["bv"]))

    scale = scalar_as(1.0 / math.sqrt(d_k), x.dtype)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    attn = matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if mask is not None:
        attn = attn.masked_fill(~mask[:, None, None, :], -1e9)
    attn = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    attn = (attn / attn.sum(dim=-1, keepdim=True)).to(x.dtype)

    out = matmul(attn, v).transpose(1, 2).reshape(B, T, C)
    out = linear(out, p["wo"], p["bo"])
    return layer_norm(out + residual, p["ln_g"], p["ln_b"], eps=eps)
