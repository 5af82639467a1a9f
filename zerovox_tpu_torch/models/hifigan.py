"""HiFi-GAN vocoder: mel -> waveform.

mel normalisation, input conv k=7, four [leaky(0.1) -> ConvTranspose1d ->
multi-receptive-field resblock mean] stages, leaky(0.01) -> output conv ->
tanh.  Each stage is ONE call of the fused MRF stage
(ops.cuda.mrf_stage): the upsample, its bias and the leaky-relus on either
side run inside it, so on the card the upsampled activation never reaches
device memory.  `pack_vocoder` puts the stages' weights in the kernel's
layout once per model; a serving caller passes the result to `vocode`.
A stage whose geometry the kernel does not take (`stage_routes`, from
ops.cuda.mrf_stage.kernel_takes: a width outside 32-512 in float32, or
32-256 in bfloat16 and under f16_staging, say, as every stage of
TINY_CONFIG; or resblocks of different kernel sizes outside bfloat16)
runs the kernel's plain version on every device, as
the JAX vocoder runs such stages through XLA convs.  Each resblock runs
at its own kernel size (cfg.resblock_kernels: zerovox's 3 for all, V1's
3/7/11).
Everything runs in the params' dtype: float32, or bfloat16 after
cast_params (the MRF stages then take the kernel's bf16 mode).  Under
ops.conv.f16_staging (`--verify`) every conv of a float32 vocoder takes f16
operands: the input and output convs and the plain stages through ops.conv,
the kernel's stages in its f16-staged mode (their packed weights must be
packed under the staging too; vocode packs them per call when none are
passed).
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

__all__ = ["vocode", "pack_vocoder", "stage_routes", "vocoder_input", "vocode_stage",
           "vocoder_output", "residual_block", "receptive_field_frames"]


def receptive_field_frames(cfg: ZeroVoxConfig) -> int:
    """Right-side halo, in mel frames, beyond which truncating the mel cannot
    change earlier output samples (the serving engine's bucket margin).
    ConvTranspose(stride s, kernel k) maps an input halo h to s*h + k output
    samples; an MRF stage adds the max over resblocks of its summed conv
    halos, each resblock at its own kernel size (9 frames for zerovox
    medium, 15 for HiFi-GAN V1)."""
    k_half = (cfg.hifigan_kernel_size - 1) // 2
    mrf = max(sum((k - 1) // 2 * (d + 1) for d in dil)
              for dil, k in zip(cfg.resblock_dilations, cfg.resblock_kernels))
    h = k_half
    for scale, k in zip(cfg.upsample_scales, cfg.upsample_kernel_sizes):
        h = h * scale + k + mrf
    h += k_half
    return -(-h // cfg.hop_size)


def _stage_blocks(voc: dict, cfg: ZeroVoxConfig, i: int) -> list:
    return [voc["blocks"][i * cfg.num_resblocks + j] for j in range(cfg.num_resblocks)]


def stage_routes(params: dict, cfg: ZeroVoxConfig) -> List[bool]:
    """Per MRF stage, whether the kernel takes it (kernel_takes on the
    stage's widths, upsample and resblocks, in the params' dtype and the
    calling context's f16_staging): True for
    every stage of zerovox medium and, in bfloat16, of HiFi-GAN V1, False
    for every stage of TINY_CONFIG (C = 16, 8, 4)."""
    ups = params["vocoder"]["upsamples"]
    return [kernel_takes(up["w"].shape[0], cfg.resblock_dilations[:cfg.num_resblocks],
                         cfg.resblock_kernels, up["w"].shape[1], up["w"].shape[2], scale,
                         up["w"].dtype)
            for up, scale in zip(ups, cfg.upsample_scales)]


def pack_vocoder(params: dict, cfg: ZeroVoxConfig) -> List[Optional[PackedStage]]:
    """Each MRF stage's weights in the kernel's layout (ops.cuda.mrf_stage.
    pack_stage), on the device the params lie on and in their dtype; made
    once per model.  None for a stage the kernel does not take
    (stage_routes)."""
    voc = params["vocoder"]
    return [pack_stage(_stage_blocks(voc, cfg, i), cfg.resblock_dilations,
                       cfg.resblock_kernels, voc["upsamples"][i]["w"]) if takes else None
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
    c = vocoder_input(voc, cfg, mel, conv)
    routes = [False] * len(cfg.upsample_scales) if plain else stage_routes(params, cfg)
    for i, kernel in enumerate(routes):
        c = vocode_stage(voc, cfg, i, c, kernel, None if packed is None else packed[i],
                         products)
    c = vocoder_output(voc, cfg, c, mel.shape[1] * cfg.hop_size, conv)
    tap("dbg", c)                # the reference's permanent probe, (B, wav_len, 1)
    return tap("wav", c[..., 0])


def vocoder_input(voc: dict, cfg: ZeroVoxConfig, mel: torch.Tensor, conv=conv1d) -> torch.Tensor:
    """The vocoder's first segment: mel normalisation and the input conv."""
    mel = mel.to(voc["input_conv_w"].dtype)
    x = (mel - voc["mean"]) / voc["scale"]
    pad = (cfg.hifigan_kernel_size - 1) // 2
    return conv(x, voc["input_conv_w"], voc["input_conv_b"], padding=pad)


def vocode_stage(voc: dict, cfg: ZeroVoxConfig, i: int, c: torch.Tensor, kernel: bool,
                 packed: Optional[PackedStage] = None, products: Optional[dict] = None
                 ) -> torch.Tensor:
    """MRF stage i on its pre-upsample input c: the upsample, its bias and
    the leaky-relus on either side fused into one mrf_stage call (kernel:
    the route stage_routes gives it), else through mrf_stage_ref with
    `products` (ops.conv's signatures; default ops.conv's own)."""
    scale, last = cfg.upsample_scales[i], i == len(cfg.upsample_scales) - 1
    up = voc["upsamples"][i]
    args = (_stage_blocks(voc, cfg, i), cfg.resblock_dilations, cfg.resblock_kernels)
    opts = dict(upsample=dict(w=up["w"], stride=scale, padding=scale // 2 + scale % 2,
                              output_padding=scale % 2),
                in_bias=up["b"],
                # the input conv applies no activation; every later stage
                # already ends in the leaky the next upsample needs
                in_leaky=0.1 if i == 0 else None,
                out_leaky=0.01 if last else 0.1)
    if not kernel:
        return mrf_stage_ref(c, *args, **opts, **(products or {}))
    return mrf_stage(c.contiguous(), *args, **opts, packed=packed)


def vocoder_output(voc: dict, cfg: ZeroVoxConfig, c: torch.Tensor, wav_len: int,
                   conv=conv1d) -> torch.Tensor:
    """The vocoder's tail after the last stage (which ends in its leaky):
    the output conv and tanh, cut to wav_len samples, (B, wav_len, 1)."""
    pad = (cfg.hifigan_kernel_size - 1) // 2
    c = torch.tanh(conv(c, voc["output_conv_w"], voc["output_conv_b"], padding=pad))
    return c[:, :wav_len]        # nonstandard upsample kernels overshoot
