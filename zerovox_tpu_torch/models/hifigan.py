"""HiFi-GAN vocoder: mel -> waveform.

mel normalisation, input conv k=7, four [leaky(0.1) -> ConvTranspose1d ->
multi-receptive-field resblock mean] stages, leaky(0.01) -> output conv ->
tanh.  Each stage is ONE call of the fused MRF stage
(ops.cuda.mrf_stage): the upsample, its bias and the leaky-relus on either
side run inside it, so on the card the upsampled activation never reaches
device memory.  `pack_vocoder` puts the stages' weights in the kernel's
layout once per model; a serving caller passes the result to `vocode`.
A stage whose geometry the kernel does not take (`stage_routes`, from
ops.cuda.mrf_stage.kernel_takes: a width outside 32-512, say, as every
stage of TINY_CONFIG) runs the kernel's plain version on every device, as
the JAX vocoder runs such stages through XLA convs.
Everything runs in the params' dtype: float32, or bfloat16 after
cast_params (the MRF stages then take the kernel's bf16 mode).
Training differentiates through the vocoder with `differentiable=True`:
the stages then run the kernel's plain version, on any device (the
kernel has no backward).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..config import ZeroVoxConfig
from ..ops import conv1d
from ..ops.cuda.mrf_stage import (PackedStage, kernel_takes, mrf_stage, mrf_stage_ref,
                                  pack_stage, residual_block)
from ..utils.debug import tap

__all__ = ["vocode", "pack_vocoder", "stage_routes", "residual_block",
           "receptive_field_frames"]


def receptive_field_frames(cfg: ZeroVoxConfig) -> int:
    """Right-side halo, in mel frames, beyond which truncating the mel cannot
    change earlier output samples (the serving engine's bucket margin).
    ConvTranspose(stride s, kernel k) maps an input halo h to s*h + k output
    samples; an MRF stage adds the max over resblocks of its summed conv
    halos."""
    k_half = (cfg.hifigan_kernel_size - 1) // 2
    rk_half = (cfg.resblock_kernel_size - 1) // 2
    mrf = max(sum(d * rk_half + rk_half for d in dil)
              for dil in cfg.resblock_dilations)
    h = k_half
    for scale, k in zip(cfg.upsample_scales, cfg.upsample_kernel_sizes):
        h = h * scale + k + mrf
    h += k_half
    return -(-h // cfg.hop_size)


def _stage_blocks(voc: dict, cfg: ZeroVoxConfig, i: int) -> list:
    return [voc["blocks"][i * cfg.num_resblocks + j] for j in range(cfg.num_resblocks)]


def stage_routes(params: dict, cfg: ZeroVoxConfig) -> List[bool]:
    """Per MRF stage, whether the kernel takes it (kernel_takes on the
    stage's widths, upsample and resblocks, in the params' dtype): True for
    every stage of the production geometry, False for every stage of
    TINY_CONFIG (C = 16, 8, 4)."""
    ups = params["vocoder"]["upsamples"]
    return [kernel_takes(up["w"].shape[0], cfg.resblock_dilations[:cfg.num_resblocks],
                         cfg.resblock_kernel_size, up["w"].shape[1], up["w"].shape[2], scale,
                         up["w"].dtype)
            for up, scale in zip(ups, cfg.upsample_scales)]


def pack_vocoder(params: dict, cfg: ZeroVoxConfig) -> List[Optional[PackedStage]]:
    """Each MRF stage's weights in the kernel's layout (ops.cuda.mrf_stage.
    pack_stage), on the device the params lie on and in their dtype; made
    once per model.  None for a stage the kernel does not take
    (stage_routes)."""
    voc = params["vocoder"]
    return [pack_stage(_stage_blocks(voc, cfg, i), cfg.resblock_dilations,
                       cfg.resblock_kernel_size, voc["upsamples"][i]["w"]) if takes else None
            for i, takes in enumerate(stage_routes(params, cfg))]


def vocode(params: dict, cfg: ZeroVoxConfig, mel: torch.Tensor,
           packed: Optional[List[PackedStage]] = None,
           differentiable: bool = False, conv=None, conv_transpose=None) -> torch.Tensor:
    """mel (B, T, num_mels) -> waveform (B, T * hop_size).

    Each stage is one mrf_stage call: the CUDA kernel on a card, its plain
    version on the CPU; a stage the kernel does not take (stage_routes)
    runs mrf_stage_ref on any device.  packed: pack_vocoder(params, cfg), so
    that the kernel's launches move no weights (packed per call when
    omitted).
    differentiable: every stage through mrf_stage_ref (plain convolutions
    that autograd follows) on any device: the route of a training loss, the
    counterpart of the JAX package's vocoder_backend="folded" there.  The
    kernel refuses a CUDA call whose weights or input require a gradient.
    conv / conv_transpose: the products of the plain route, ops.conv's
    signatures (parallel.tp passes ones that split the weights over
    devices); when given, every stage runs mrf_stage_ref with them."""
    plain = differentiable or conv is not None or conv_transpose is not None
    products = dict(conv=conv, conv_transpose=conv_transpose)
    conv = conv or conv1d
    voc = params["vocoder"]
    mel = mel.to(voc["input_conv_w"].dtype)
    x = (mel - voc["mean"]) / voc["scale"]
    pad = (cfg.hifigan_kernel_size - 1) // 2
    c = conv(x, voc["input_conv_w"], voc["input_conv_b"], padding=pad)

    n_stages = len(cfg.upsample_scales)
    routes = [False] * n_stages if plain else stage_routes(params, cfg)
    for i, scale in enumerate(cfg.upsample_scales):
        up = voc["upsamples"][i]
        args = (_stage_blocks(voc, cfg, i), cfg.resblock_dilations, cfg.resblock_kernel_size)
        opts = dict(upsample=dict(w=up["w"], stride=scale, padding=scale // 2 + scale % 2,
                                  output_padding=scale % 2),
                    in_bias=up["b"],
                    # the input conv applies no activation; every later stage
                    # already ends in the leaky the next upsample needs
                    in_leaky=0.1 if i == 0 else None,
                    out_leaky=0.01 if i == n_stages - 1 else 0.1)
        if not routes[i]:
            c = mrf_stage_ref(c, *args, **opts, **products)
        else:
            c = mrf_stage(c.contiguous(), *args, **opts,
                          packed=None if packed is None else packed[i])

    c = torch.tanh(conv(c, voc["output_conv_w"], voc["output_conv_b"], padding=pad))
    wav_len = mel.shape[1] * cfg.hop_size
    c = c[:, :wav_len]           # nonstandard upsample kernels overshoot
    tap("dbg", c)                # the reference's permanent probe, (B, wav_len, 1)
    return tap("wav", c[..., 0])
