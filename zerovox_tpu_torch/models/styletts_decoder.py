"""StyleTTS mel decoder.

ResBlk1d x2 encode stack, an asr_res 1x1-conv + InstanceNorm branch, five
AdainResBlk1d stages with the asr_res features re-concatenated before the
first three only, and a 1x1 output conv.  Activations are channels-last
(B, T, C); instance norms reduce the time axis.
"""

from __future__ import annotations

import math

import torch

from ..config import ZeroVoxConfig
from ..ops import conv1d, instance_norm, leaky_relu, linear, scalar_as
from ..utils.debug import tap

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def res_blk1d(x: torch.Tensor, p: dict, cfg: ZeroVoxConfig) -> torch.Tensor:
    """ResBlk1d: shortcut(x) + [IN -> lrelu(0.2) -> conv3 -> IN -> lrelu -> conv3](x), /sqrt(2)."""
    eps = cfg.instance_norm_eps
    shortcut = conv1d(x, p["conv1x1_w"]) if "conv1x1_w" in p else x
    h = instance_norm(x, p["norm1_g"], p["norm1_b"], eps=eps)
    h = leaky_relu(h, 0.2)
    h = conv1d(h, p["conv1_w"], p["conv1_b"], padding=1)
    h = instance_norm(h, p["norm2_g"], p["norm2_b"], eps=eps)
    h = leaky_relu(h, 0.2)
    h = conv1d(h, p["conv2_w"], p["conv2_b"], padding=1)
    return (h + shortcut) * scalar_as(_INV_SQRT2, h.dtype)


def adain(x: torch.Tensor, style: torch.Tensor, fc_w, fc_b, eps: float) -> torch.Tensor:
    """AdaIN1d: gamma, beta = chunk(fc(style), 2); (1+gamma) * IN(x) + beta."""
    h = linear(style, fc_w, fc_b)                     # (B, 2C)
    c = h.shape[-1] // 2
    gamma, beta = h[..., :c], h[..., c:]
    return (1.0 + gamma)[:, None, :] * instance_norm(x, eps=eps) + beta[:, None, :]


def adain_res_blk1d(x: torch.Tensor, style: torch.Tensor, p: dict,
                    cfg: ZeroVoxConfig) -> torch.Tensor:
    """AdainResBlk1d."""
    eps = cfg.instance_norm_eps
    h = adain(x, style, p["fc1_w"], p["fc1_b"], eps)
    h = leaky_relu(h, 0.2)
    h = conv1d(h, p["conv1_w"], p["conv1_b"], padding=1)
    h = adain(h, style, p["fc2_w"], p["fc2_b"], eps)
    h = leaky_relu(h, 0.2)
    h = conv1d(h, p["conv2_w"], p["conv2_b"], padding=1)
    shortcut = conv1d(x, p["conv1x1_w"]) if "conv1x1_w" in p else x
    return (h + shortcut) * scalar_as(_INV_SQRT2, h.dtype)


def decode(params: dict, cfg: ZeroVoxConfig,
           hidden: torch.Tensor, style_embed: torch.Tensor,
           res_blk=res_blk1d, adain_blk=adain_res_blk1d) -> torch.Tensor:
    """Encoder hiddens (B, T, d_model) + style (B, d_model) -> mel (B, T, num_mels).

    res_blk / adain_blk: the two block kinds (parallel.tp passes its
    channel-sharded ones, with a tree of shards)."""
    dec = params["decoder"]
    eps = cfg.instance_norm_eps
    dt = dec["to_out"]["conv_w"].dtype
    hidden = hidden.to(dt)
    style_embed = style_embed.to(dt)

    x = res_blk(hidden, dec["encode0"], cfg)
    x = res_blk(x, dec["encode1"], cfg)

    a = dec["asr_res"]
    asr_res = instance_norm(conv1d(hidden, a["conv_w"], a["conv_b"]),
                            a["norm_g"], a["norm_b"], eps=eps)

    for name in ("decode0", "decode1", "decode2"):
        x = torch.cat([x, asr_res], dim=-1)
        x = adain_blk(x, style_embed, dec[name], cfg)
    x = adain_blk(x, style_embed, dec["decode3"], cfg)
    x = adain_blk(x, style_embed, dec["decode4"], cfg)

    out = dec["to_out"]
    return tap("mel", conv1d(x, out["conv_w"], out["conv_b"]))
