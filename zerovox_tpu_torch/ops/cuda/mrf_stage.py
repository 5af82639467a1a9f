"""The vocoder's fused MRF stage: the hand-written CUDA kernel and its plain version.

`mrf_stage` is the port of zerovox_tpu/ops/pallas/folded_mrf.py's
`folded_mrf_stage` (the TPU kernel `_mrf_kernel`): one whole HiFi-GAN
multi-receptive-field stage, optionally with the preceding ConvTranspose1d
upsample, its bias and the leaky-relus on either side fused in.
`mrf_stage_unfolded` is the same kernel with every option off, the port of
`mrf_stage_unfolded`.  The kernel sources are zerovox_tpu_torch/csrc/
mrf_stage.cu (the float32 mode) and csrc/mrf_stage_bf16.cu (the bfloat16
serving mode and the f16-staged mode).

For a CUDA tensor the wrappers launch the kernel or raise; they take the
plain version (`mrf_stage_ref`, built from F.conv1d / F.conv_transpose1d)
only for tensors that lie on the CPU.  Which stages go to the kernel is the
caller's choice, made before any launch: `kernel_takes` says, in plain
Python, whether the kernel takes a stage's geometry (hifigan.vocode sends
the others to mrf_stage_ref on the card, as the JAX vocoder sends them to
XLA).  Each wrapper counts its kernel
launches in a plain integer attribute (`mrf_stage.launches`; those in the
f16-staged mode also in `mrf_stage.staged_launches`), added to under a lock:
a serving daemon launches from many threads.  The kernel
reads its weights in its own layout (`pack_stage`), which a serving caller
makes once per model and passes as `packed=`.

The kernel runs each conv on the tensor cores, one resblock per CTA in a
cluster of one CTA per resblock; `tile_plan` chooses its geometry in plain
Python, so the CPU tests reach it.  It takes three modes, chosen by the
input's dtype and ops.conv's f16_staging:

  float32   f32 accuracy (3xTF32 mma.sync: `split_tf32` mirrors its operand
            split); C in 32/64/128/256/512.
  bfloat16  the serving mode (the TPU kernel's dot_bf16), its own source and
            design (wgmma on operand planes, weight chunks bulk-copied
            into a ring, the upsample on the tensor cores; `bf16_plan`): input,
            output and weights are bf16 in device memory, every conv's
            operands are rounded to bf16 (after the leaky) once per conv, and
            the accumulators, the biases, the residual and the resblock sum
            are f32; the result is rounded once, on the store.  C in
            32/64/128/256, an upsample of k = t * s.  `mrf_stage_ref`
            computes the same for bf16 tensors (`round_bf16` on each conv's
            operand, f32 convs on exactly representable products).
  f16-staged  float32 under f16_staging (`--verify`'s simulation of the
            ggml reference), on the bfloat16 mode's design and geometry
            (csrc/mrf_stage_bf16.cu built with ZV_MRF_F16_STAGED; wgmma on
            f16 operand planes): f32 input, output and chain state, every
            conv's operands (the upsample's too, with or without in_leaky)
            rounded to f16 after the leaky, weights packed as f16 planes
            (`pack_stage` rounds them), f16 products exact and summed in
            f32, the output written f32, unrounded.  C in 32/64/128/256, an
            upsample of k = t * s.  `mrf_stage_ref` computes the same
            through ops.conv's staging.  The TPU kernel has no such mode:
            the JAX vocoder staged only on its XLA route.

A bf16 input with f32 weights (or the reverse) raises, and so does a bf16
call under f16_staging (no entry point asks for one; the kernel has no such
mode).

The kernel has no backward (neither has the TPU kernel: the JAX package's
training takes plain convolutions, zerovox_tpu/training/train.py:101-106).
With autograd on, a CUDA call whose input or weights require a gradient
raises (`refuse_autograd`) instead of returning a result detached from the
graph; training takes `hifigan.vocode(..., differentiable=True)`, which runs
`mrf_stage_ref`.

The kernel is compiled with nvcc, at its first CUDA call (never at import),
into the port's build directory (utils.compile_cache.build_dir():
build/zerovox_tpu_torch/ at the root of the checkout, or --compile-cache's
DIR; a build of the same source and flags found there is reused), as one shared
library per mode (csrc/mrf_stage.cu; csrc/mrf_stage_bf16.cu as it is and with
-DZV_MRF_F16_STAGED=1; the three nvcc runs started together) with a plain C
interface loaded through ctypes.  The build is guarded
by a lock: concurrent first calls (a server made without a warm-up) wait
for the one nvcc run.  A mode whose library does not build or launch raises:
nothing falls back to another mode or to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import torch

from ..conv import (conv1d, conv_transpose1d, staging, transpose_out_len,
                    unflip_transpose_weight)
from ..misc import leaky_relu

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "mrf_stage.cu"            # the float32 mode
SOURCE_BF16 = _PKG / "csrc" / "mrf_stage_bf16.cu"  # the bfloat16 and f16-staged modes
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Limits shared with csrc/mrf_stage.cu (which rejects a geometry that breaks them)
_WARPS = 8                # warps per CTA
_STAGES = 3               # weight ring depth (chunks in flight)
_CHUNK_FLOATS = 8192      # weight chunk target (32-bit words): one tap x kc channels x C
_MAX_RB = 8               # resblocks per stage (= CTAs per cluster)
_MAX_D = 8                # dilations per resblock
_SMEM_MAX = 232448        # dynamic shared memory one CTA may use (bytes)
_SMS = 132                # streaming multiprocessors of an H100 SXM
_MT = {8: 3, 4: 6}        # kernel instances: n8 column tiles per warp -> m16 row tiles
_KC = {8: (16, 32, 64), 4: (16, 32)}   # ... and their weight chunks (input channels)
# The modes on csrc/mrf_stage_bf16.cu's wgmma design (bf16_plan's geometry)
_WGMMA_MODES = ("bf16", "f16_staged")
# Limits shared with csrc/mrf_stage_bf16.cu: its instances (C -> the input
# channels a weight chunk may hold) and its ring of weight chunks
_BF16_KB = {256: (16, 64), 128: (32, 128), 64: (64,), 32: (32,)}
# ... and their 64-row M-tiles per warpgroup: 256 / C (128 accumulators a
# thread, one CTA an SM), at C=32 128 / C (64, two CTAs an SM: 16 warps hide
# the epilogues' latency)
_BF16_MT = {256: 1, 128: 2, 64: 4, 32: 4}
_BF16_STAGES = 16
_SMEM_2 = 115712          # dynamic shared memory each of two CTAs of an SM may use (bytes)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even, as XLA's convert and the kernel's
    cvt.rn) and widened back: an f32 tensor of bf16 values."""
    return t.to(torch.bfloat16).to(torch.float32)


def residual_block(x: torch.Tensor, p: dict, dilations, kernel_size: int,
                   conv=None) -> torch.Tensor:
    """Multi-dilation residual block: per dilation d,
    x += conv2(leaky(conv1_d(leaky(x), dil=d), 0.1)) (both with bias).

    With bf16 weights x is the f32 chain state: each conv's operand is
    rounded to bf16 after the leaky and multiplied in f32 (exact products,
    f32 sums), the bias is added in f32 and the result stays f32.
    conv: the product, ops.conv1d's signature (parallel.tp passes one that
    splits the weights over devices); default ops.conv1d."""
    conv = conv or conv1d
    half_k = (kernel_size - 1) // 2
    dot_bf16 = p["convs1"][0]["w"].dtype == torch.bfloat16
    operand = round_bf16 if dot_bf16 else (lambda t: t)
    for d_idx, dilation in enumerate(dilations):
        c1 = p["convs1"][d_idx]
        c2 = p["convs2"][d_idx]
        xt = operand(leaky_relu(x, 0.1))
        xt = conv(xt, c1["w"].to(x.dtype), c1["b"].to(x.dtype),
                  padding=half_k * dilation, dilation=dilation)
        xt = operand(leaky_relu(xt, 0.1))
        xt = conv(xt, c2["w"].to(x.dtype), c2["b"].to(x.dtype), padding=half_k)
        x = x + xt
    return x


def mrf_stage_ref(x: torch.Tensor,
                  blocks: Sequence[dict],
                  dilation_sets: Sequence[Sequence[int]],
                  kernel_size: int,
                  upsample: Optional[dict] = None,
                  in_bias: Optional[torch.Tensor] = None,
                  in_leaky: Optional[float] = None,
                  out_leaky: Optional[float] = None,
                  conv=None, conv_transpose=None) -> torch.Tensor:
    """Plain PyTorch version of the fused stage (same arguments as mrf_stage;
    conv / conv_transpose: the products, ops.conv's signatures, default
    ops.conv1d / conv_transpose1d).

    For bf16 tensors it computes what the kernel's bf16 mode computes (and
    the TPU kernel's dot_bf16), not a bf16 convolution: the chain state is
    f32, only the operands of each product are bf16 values, and the output
    is rounded once, after 1/n and out_leaky.  It also takes float64 (the
    kernel does not): the reference training's gradient checks hold the
    float32 route against; the chain is then float64."""
    _check_options(upsample, in_leaky)
    dtype = x.dtype
    _check_dtypes(dtype, blocks, upsample, plain=True)
    chain = torch.float64 if dtype == torch.float64 else torch.float32
    x = x.to(chain)
    if upsample is not None:
        if in_leaky is not None:
            x = leaky_relu(x, in_leaky)
            if dtype == torch.bfloat16:
                x = round_bf16(x)
        x = (conv_transpose or conv_transpose1d)(
            x, upsample["w"].to(chain), None, stride=upsample["stride"],
            padding=upsample["padding"], output_padding=upsample["output_padding"])
    if in_bias is not None:
        x = x + in_bias.to(chain)
    acc = None
    for j, blk in enumerate(blocks):
        r = residual_block(x, blk, dilation_sets[j], kernel_size, conv)
        acc = r if acc is None else acc + r
    out = acc * (1.0 / len(blocks))
    if out_leaky is not None:
        out = leaky_relu(out, out_leaky)
    return out.to(dtype)


def _check_options(upsample, in_leaky):
    if in_leaky is not None and upsample is None:
        raise ValueError("in_leaky acts on the pre-upsample input; it needs upsample=")


def _check_dtypes(dtype, blocks, upsample, plain: bool = False):
    """The stage runs in one dtype, float32 or bfloat16 (the plain version
    also float64): the input's; bfloat16 not under f16_staging."""
    allowed = (torch.float32, torch.bfloat16) + ((torch.float64,) if plain else ())
    if dtype not in allowed:
        raise TypeError(f"mrf_stage takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and staging():
        raise TypeError("mrf_stage: a bfloat16 stage under f16_staging: no entry point asks "
                        "for one (--verify stages float32), and the kernel has no such mode")
    ws = [c["w"] for blk in blocks for cs in ("convs1", "convs2") for c in blk[cs]]
    if upsample is not None:
        ws.append(upsample["w"])
    for w in ws:
        if w.dtype != dtype:
            raise TypeError(f"mrf_stage: the input is {dtype}, a weight {w.dtype}; cast the "
                            f"params and the input to one dtype")


# --------------------------------------------------------------------------
# launch geometry (plain Python, so the CPU tests reach it)
# --------------------------------------------------------------------------

def stage_halo(dilation_sets: Sequence[Sequence[int]], kernel_size: int) -> int:
    """Per-side receptive field (rows) of the worst resblock of one stage:
    12 at k=3 and dilations (1, 3, 5)."""
    half = (kernel_size - 1) // 2
    return max(sum(half * (d + 1) for d in dils) for dils in dilation_sets)


def split_tf32(v: torch.Tensor):
    """(hi, lo) with v = hi + lo + O(2^-22 |v|), both TF32 values (the low 13
    mantissa bits zero): the kernel's split of every MMA operand,
    hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi) (round to nearest, ties
    away from zero).  The kernel accumulates hi*hi + hi*lo + lo*hi."""
    def rna(u):
        bits = u.to(torch.float32).contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(v)
    return hi, rna(v - hi)


class TilePlan(NamedTuple):
    """Launch geometry of the float32 mode (csrc/mrf_stage.cu)."""
    tile: int        # output rows per cluster (its CTAs run one resblock each)
    clusters: int    # clusters per launch (B x time tiles); 0 with no L_out
    ss: int          # window row stride (floats: C + 4)
    kc: int          # input channels per weight chunk (one tap)
    stages: int      # weight ring depth
    nt: int          # n8 column tiles per warp
    mt: int          # m16 row tiles per warp
    smem: int        # dynamic shared memory per CTA (bytes)


def warp_grid(C: int):
    """(nt, mt, warps_m): the warp tile of a C-channel stage.  The 8 warps
    split C over warps_n = C / (8 nt) column groups and the rows over
    warps_m = 8 / warps_n; a warp holds mt x nt accumulator fragments."""
    nt = 8 if C % 64 == 0 else 4
    if C < 32 or C % 32 or _WARPS % (C // (8 * nt)):
        raise ValueError(f"mrf_stage kernel takes C in 32/64/128/256/512, got C={C}")
    return nt, _MT[nt], _WARPS // (C // (8 * nt))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _upsample_fits(tile, halo, up_cin, up_k, up_stride, ss) -> bool:
    """Whether the pre-upsample rows of a tile fit the conv1-output window
    that stages them (always, without an upsample)."""
    return not up_cin or ((tile + 2 * halo + up_k - 2) // up_stride + 2) * up_cin \
        <= (tile + 2 * halo) * ss


def _geometry(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, kc,
              stages):
    nt, mt, warps_m = warp_grid(C)
    if kc not in _KC[nt] or C % kc or not 2 <= stages <= 8:
        raise ValueError(f"mrf_stage kernel: chunks of {kc} channels (one of "
                         f"{_KC[nt]}, dividing C={C}) in a ring of 2-8, "
                         f"got a ring of {stages}")
    halo = stage_halo(dilation_sets, kernel_size)
    half = (kernel_size - 1) // 2
    ss = C + 4
    ring = stages * kc * C                        # 32-bit words
    window = min(warps_m * mt * 16 + 2 * half * min(d[0] for d in dilation_sets),
                 ((_SMEM_MAX - 16 * stages) // 4 - ring) // (2 * ss))
    tile = window - 2 * halo
    if tile < 1:
        raise ValueError(f"mrf_stage kernel: C={C} with halo {halo} leaves no room for "
                         f"a time tile beside a ring of {stages} x {kc} channels")
    clusters = 0
    if L_out is not None:
        # the waves the longest tile needs, then the shortest tile that needs
        # no more: the last wave is full and each CTA computes fewer rows
        waves = _cdiv(B * _cdiv(L_out, tile), wave)
        tile = max(1, min(tile, _cdiv(L_out, waves * wave // B)))
        clusters = B * _cdiv(L_out, tile)
    if not _upsample_fits(tile, halo, up_cin, up_k, up_stride, ss):
        raise ValueError(f"mrf_stage kernel: the pre-upsample rows of {up_cin} channels "
                         f"do not fit a window of {tile + 2 * halo} x {C} channels")
    smem = 4 * (ring + 2 * (tile + 2 * halo) * ss) + 16 * stages
    return TilePlan(tile, clusters, ss, kc, stages, nt, mt, smem)


@functools.lru_cache(maxsize=256)
def _plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, kc,
          stages):
    args = (C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave)
    stages = stages or _STAGES
    if kc:
        return _geometry(*args, kc, stages)
    nt = warp_grid(C)[0]
    chunks = _KC[nt]
    plans = []
    for k in chunks:
        if k <= max(_CHUNK_FLOATS // C, _KC[nt][0]) and C % k == 0:
            with contextlib.suppress(ValueError):
                plans.append(_geometry(*args, k, stages))
    if not plans:
        raise ValueError(f"mrf_stage kernel: no weight chunk of {chunks} channels fits C={C}")
    # the largest chunk whose tile is within a tenth of the longest any chunk
    # gives: a smaller ring lengthens the tile where shared memory sets it
    # (fewer recomputed halo rows, fewer waves), at the cost of more chunks
    longest = max(p.tile for p in plans)
    return [p for p in plans if 1.1 * p.tile >= longest][-1]


def tile_plan(C: int, dilation_sets: Sequence[Sequence[int]], kernel_size: int = 3,
              up_cin: int = 0, up_k: int = 0, up_stride: int = 1, B: int = 1,
              L_out: Optional[int] = None, wave: Optional[int] = None,
              kc: Optional[int] = None, stages: Optional[int] = None,
              elem: int = 4):
    """Launch geometry for a stage of C channels with `elem`-byte tensors: 4
    (float32, csrc/mrf_stage.cu) gives a TilePlan; 2 (bfloat16) gives
    bf16_plan's Bf16Plan (kc does not apply there).

    A cluster of len(dilation_sets) CTAs takes one time tile, a CTA per
    resblock.  Shared memory holds the weight ring (`stages` chunks of
    kc x C f32 weights) and two f32 windows of tile + 2*halo rows of C + 4
    floats; the warps' row tiles must cover the first conv's rows, and the
    pre-upsample rows must fit the conv1-output window, which stages them.
    Without L_out the tile is the longest that fits.  With B and L_out it is
    the shortest tile that needs no more waves than the longest (a wave:
    `wave` clusters, by default 132 SMs // cluster size): where the longest
    tile leaves the card short of one wave, the tile shrinks until the grid
    fills it, and where it needs several, until the last wave is full; the
    extra halo rows cost less than the idle SMs.  The chunk (kc input
    channels, at most 8192 floats) is the largest of the kernel instance's
    whose tile is within a tenth of the longest tile any of them gives.  kc
    and stages replace the chunk and the ring depth (3), to measure
    variants.  Raises ValueError for a stage the kernel cannot hold."""
    if elem == 2:
        return bf16_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out,
                         wave, stages=stages)
    if elem != 4:
        raise ValueError(f"mrf_stage kernel: 2-byte (bf16) or 4-byte (f32) tensors, got {elem}")
    dils = tuple(tuple(int(d) for d in ds) for ds in dilation_sets)
    wave = wave or max(1, _SMS // len(dils))
    return _plan(C, dils, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, kc, stages)


class Bf16Plan(NamedTuple):
    """Launch geometry of the bfloat16 and f16-staged modes (csrc/mrf_stage_bf16.cu)."""
    tile: int          # output rows per cluster (its CTAs run one resblock each)
    clusters: int      # clusters per launch (B x time tiles); 0 with no L_out
    window: int        # rows a CTA holds: tile + 2 * halo
    margin: int        # operand plane rows before window row 0: the largest tap shift
    plane_rows: int    # rows of an operand plane: the window's 64-row M-tiles + 2 margins
    np_rows: int       # rows of a pre-upsample plane (0 without an upsample)
    kb: int            # input channels per weight chunk (the instance's)
    stages: int        # weight ring slots
    mt: int            # 64-row M-tiles per consumer warpgroup (its accumulators)
    buf: int           # bytes of the operand buffer (operand or pre-upsample planes)
    smem: int          # dynamic shared memory per CTA (bytes)


def _bf16_geometry(C, dils, kernel_size, up_cin, up_k, up_stride, window, stages, kb):
    """The plan of one window with chunks of kb input channels."""
    mt = _BF16_MT[C]
    if kb not in _BF16_KB[C] or (up_cin and up_cin % kb) or window > 128 * mt:
        raise ValueError(f"mrf_stage kernel (bf16): chunks of {kb} channels (one of "
                         f"{_BF16_KB[C]} at C={C}, dividing the upsample's {up_cin}) for "
                         f"{window} rows (at most {128 * mt})")
    halo = stage_halo(dils, kernel_size)
    margin = (kernel_size - 1) // 2 * max(max(d) for d in dils)
    smem_max = _SMEM_MAX if mt * C > 128 else _SMEM_2
    chunk = kb * C * 2
    plane_rows = 64 * _cdiv(window, 64) + 2 * margin
    np_rows = (up_k // up_stride + 1 + 64 * _cdiv(_cdiv(window, up_stride), 64)) if up_cin else 0
    buf = max(plane_rows * C * 2, np_rows * up_cin * 2)
    fixed = buf + 4 * window * C + 4 * C            # + the epilogue's bias
    fit = min(_BF16_STAGES, (smem_max - fixed) // (chunk + 16))
    stages = stages or fit
    if not 2 <= stages <= fit:
        raise ValueError(f"mrf_stage kernel: a window of {window} rows at C={C} leaves room "
                         f"for a ring of {fit} chunks, not {stages} (2-{_BF16_STAGES})")
    return Bf16Plan(window - 2 * halo, 0, window, margin, plane_rows, np_rows, kb, stages, mt,
                    buf, stages * (chunk + 16) + fixed)


@functools.lru_cache(maxsize=256)
def _bf16_plan(C, dils, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, window, stages,
               kb):
    if C not in _BF16_KB:
        raise ValueError(f"mrf_stage kernel takes C in 32/64/128/256 in bfloat16, got C={C}")
    if kernel_size % 2 != 1:
        raise ValueError(f"resblock kernel size must be odd, got {kernel_size}")
    if up_cin and (up_cin % min(_BF16_KB[C]) or up_k < up_stride or up_k % up_stride):
        raise ValueError(f"mrf_stage kernel (bf16): an upsample of {up_cin} input channels "
                         f"(a multiple of {min(_BF16_KB[C])}) and a kernel of a multiple of its "
                         f"stride, got k={up_k}, s={up_stride}")
    halo = stage_halo(dils, kernel_size)
    mt = _BF16_MT[C]
    longest = None
    # the largest chunk of the instances that leaves a window (the weight
    # stream from L2 moves larger copies faster, PERF.md), at its longest
    for k in [kb] if kb else sorted((k for k in _BF16_KB[C] if not up_cin or up_cin % k == 0),
                                    reverse=True):
        for w in range(min(window or 128 * mt, 128 * mt), 2 * halo, -1):
            with contextlib.suppress(ValueError):
                longest = _bf16_geometry(C, dils, kernel_size, up_cin, up_k, up_stride, w,
                                         stages, k)
                break
        if longest is not None:
            break
    if longest is None:
        raise ValueError(f"mrf_stage kernel (bf16): C={C} with halo {halo} leaves no room for "
                         f"a time tile")
    if L_out is None:
        return longest
    # the waves the longest tile needs, then the shortest tile that needs no more
    waves = _cdiv(B * _cdiv(L_out, longest.tile), wave)
    tile = max(1, min(longest.tile, _cdiv(L_out, max(1, waves * wave // B))))
    plan = _bf16_geometry(C, dils, kernel_size, up_cin, up_k, up_stride, tile + 2 * halo,
                          stages, longest.kb)
    return plan._replace(clusters=B * _cdiv(L_out, tile))


def bf16_plan(C: int, dilation_sets: Sequence[Sequence[int]], kernel_size: int = 3,
              up_cin: int = 0, up_k: int = 0, up_stride: int = 1, B: int = 1,
              L_out: Optional[int] = None, wave: Optional[int] = None,
              window: Optional[int] = None, stages: Optional[int] = None,
              kb: Optional[int] = None) -> Bf16Plan:
    """Launch geometry of the bfloat16 kernel (csrc/mrf_stage_bf16.cu) for a
    stage of C channels (32/64/128/256); the f16-staged mode's too (its f16
    operand planes and f32 h window take the same shared memory).

    A cluster of len(dilation_sets) CTAs takes one time tile, a CTA per
    resblock.  Its two warpgroups hold every 64-row M-tile of the window
    (tile + 2*halo rows) in registers, mt tiles each (_BF16_MT), so a window
    has at most 128 * mt rows: 32768 / C with 128 f32 accumulators a thread
    and one CTA an SM, or at C=32 512 rows with 64 accumulators and two CTAs
    an SM, each with half the shared memory.  Shared memory holds the f32 h
    window (window x C), one operand buffer (C/8 planes of plane_rows rows of
    16 bytes, margins of the largest tap shift on both sides; or, before the
    chain, the pre-upsample rows as up_cin/8 planes of np_rows rows) and the
    weight ring, which takes what is left, 2 to 16 chunks of kb x C bf16.
    The chunk is the largest the instances have for C (64 input channels at
    C=256, 128 at C=128: 32 KB copies) and the window the longest that
    leaves it two slots: the weight stream from L2 bounds the wide stages,
    and larger copies move it faster than a longer window saves.
    Without L_out the window is the longest that fits.  With B and L_out the
    tile is the shortest that needs no more waves of `wave` clusters than the
    longest (as tile_plan).  window, stages and kb replace the longest
    window, the ring depth and the chunk, to measure variants.
    Raises ValueError for a stage the
    kernel cannot hold: another width, an even kernel size, an upsample of a
    width not in whole chunks or a kernel that is not a multiple of its
    stride."""
    dils = tuple(tuple(int(d) for d in ds) for ds in dilation_sets)
    wave = wave or max(1, _SMS // len(dils))
    return _bf16_plan(C, dils, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, window,
                      stages, kb)


def kernel_takes(C: int, dilation_sets: Sequence[Sequence[int]], kernel_size: int = 3,
                 up_cin: int = 0, up_k: int = 0, up_stride: int = 1,
                 dtype: torch.dtype = torch.float32) -> bool:
    """Whether the kernel takes a stage of this geometry in the mode a stage
    of `dtype` runs in the calling context (kernel_mode: float32 under
    ops.conv's f16_staging is the f16-staged mode), at any batch size and
    length: C channels, one resblock per entry of dilation_sets, and
    (up_cin > 0) an upsample of up_cin input channels, kernel up_k and
    stride up_stride.  Plain Python, so the CPU tests reach it; the vocoder
    runs a stage it does not take through the plain version
    (mrf_stage_ref), on the card too.  It asks what _launch and the mode's
    plan ask: an odd kernel size, 1-8 resblocks of 1-8 dilations >= 1, a
    width and chunk the mode's instances hold (float32: 32-512; bfloat16
    and f16-staged: 32-256), upsample input channels in 16-byte groups
    (bfloat16 and f16-staged: in whole weight chunks, and an upsample kernel
    that is a multiple of its stride), and (float32) a tile plan whose
    pre-upsample rows fit at every tile length a launch can choose (1 up to
    the longest).  The answer is cached per mode."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    return _takes(C, tuple(tuple(int(d) for d in ds) for ds in dilation_sets), kernel_size,
                  up_cin, up_k, up_stride, kernel_mode(dtype))


@functools.lru_cache(maxsize=256)
def _takes(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, mode) -> bool:
    wgmma = mode in _WGMMA_MODES
    if kernel_size % 2 != 1 or not 1 <= len(dilation_sets) <= _MAX_RB \
            or any(not 1 <= len(d) <= _MAX_D or min(d) < 1 for d in dilation_sets) \
            or (up_cin and up_cin % (8 if wgmma else 4)):
        return False
    try:
        if wgmma:
            bf16_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride)
            return True        # a shorter window needs less of every buffer
        plan = tile_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride)
    except ValueError:
        return False
    halo = stage_halo(dilation_sets, kernel_size)
    return all(_upsample_fits(t, halo, up_cin, up_k, up_stride, plan.ss)
               for t in range(1, plan.tile + 1))


# --------------------------------------------------------------------------
# build + bind
# --------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin): the mrf_stage "
                       "kernel is built from source at its first CUDA call")


class Library(NamedTuple):
    """The kernel's three builds and what nvcc said of them."""
    stage: dict            # mode ("f32", "bf16", "f16_staged") -> the mode's launch entry
    max_clusters: dict     # mode -> the mode's cluster-occupancy entry
    error_string: object   # cudaGetErrorString
    build_log: str         # nvcc's output, every mode (ptxas registers and spills)
    build_seconds: float   # wall time of the compile, 0 when earlier builds were reused
    probe: Optional[dict] = None   # wgmma mode -> its library's descriptor probe (wgmma_probe)
    lbo_is_k: int = 1      # their descriptors' assignment of LBO (1: across k, 0: across rows)


# (mode, source, nvcc defines, launch entry, cluster-occupancy entry): one library each
_MODES = (("f32", SOURCE, (), "zv_mrf_stage_f32", "zv_mrf_max_clusters"),
          ("bf16", SOURCE_BF16, (), "zv_mrf_stage_bf16", "zv_mrf_max_clusters_bf16"),
          ("f16_staged", SOURCE_BF16, ("-DZV_MRF_F16_STAGED=1",), "zv_mrf_stage_f16_staged",
           "zv_mrf_max_clusters_f16_staged"))
# the descriptor probe of each wgmma mode's library (bf16 or f16 operands)
_PROBES = {"bf16": "zv_wgmma_probe", "f16_staged": "zv_wgmma_probe_f16"}


def kernel_mode(dtype: torch.dtype) -> str:
    """The kernel build a stage of `dtype` runs in the calling context:
    "bf16" for bfloat16, "f32" for float32, "f16_staged" for float32 under
    ops.conv's f16_staging."""
    if dtype == torch.bfloat16:
        return "bf16"
    return "f16_staged" if staging() else "f32"


_build_lock = threading.Lock()
_library: Optional[Library] = None
_count_lock = threading.Lock()


def library() -> Library:
    """The kernel's three libraries, built and loaded by the first call; calls
    that arrive while that one builds wait for it and build nothing."""
    global _library
    if _library is None:
        with _build_lock:
            if _library is None:
                from ...utils.profiling import span
                with span("kernel.build"):      # nvcc, or the load of the built libraries
                    _library = _build_library()
    return _library


def _count_launch(wrapper, mode: str = "f32"):
    """wrapper.launches += 1 (and wrapper.staged_launches for a launch in
    the f16-staged mode), under a lock (an unlocked += loses counts between
    threads)."""
    with _count_lock:
        wrapper.launches += 1
        if mode == "f16_staged":
            wrapper.staged_launches += 1


def _so_name(tag: str, source: Path, defines) -> str:
    """The library file of a mode: named by a digest of its source, flags and
    defines, so a changed source builds anew and an unchanged one is reused."""
    digest = hashlib.sha256(source.read_bytes() + " ".join((*NVCC_FLAGS, *defines)).encode()
                            ).hexdigest()[:12]
    return f"mrf_stage_{tag}_{digest}.so"


def _build_library() -> Library:
    """Build (once per source version) and load the kernel's three
    libraries, one per mode (_MODES: csrc/mrf_stage.cu, csrc/mrf_stage_bf16.cu
    with and without ZV_MRF_F16_STAGED), every nvcc run started together.
    A failed build raises."""
    from ...utils.compile_cache import build_dir, note_loaded
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for tag, source, defines, _, _ in _MODES:
        so = out_dir / _so_name(tag, source, defines)
        if not so.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            procs[tag] = (so, tmp, source, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *defines, "-o", tmp, str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    log, failed = "", ""
    for tag, (so, tmp, source, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed += f"nvcc failed on {source} ({tag} mode):\n{err}\n"
            continue
        os.replace(tmp, so)
        log += f"[{tag}]\n{out}{err}"
    if failed:
        raise RuntimeError(failed)
    seconds = time.perf_counter() - t0 if procs else 0.0
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stage, clusters, error_string, probe, lbo_is_k = {}, {}, None, {}, 1
    for tag, source, defines, stage_name, clusters_name in _MODES:
        so = out_dir / _so_name(tag, source, defines)
        lib = ctypes.CDLL(str(so))
        note_loaded(so)
        fn = getattr(lib, stage_name)
        if tag in _WGMMA_MODES:
            fn.argtypes = [p, p, p, p, p, p,    # x w_up in_bias w b y
                           i, i, i, i, i,       # B L_in Cin C L_out
                           i, i, i,             # K_up stride pad
                           i, f, i, f,          # in/out leaky
                           i, i, i, p,          # n_rb n_dmax kr dils
                           i, i, i, i, i, i,    # halo tile window margin plane_rows np_rows
                           i, i, i, i,          # buf kb mt stages
                           i, p]                # smem stream
            cl_args = [i, i, i, i]              # n_rb C mt smem
            probe[tag] = getattr(lib, _PROBES[tag])
            probe[tag].argtypes = [p, p, p, i, i, i, p]
            probe[tag].restype = i
            lib.zv_wgmma_lbo_is_k.restype = i
            lbo_is_k = lib.zv_wgmma_lbo_is_k()
        else:
            fn.argtypes = [p, p, p, p, p, p,       # x w_up in_bias w b y
                           i, i, i, i, i,          # B L_in Cin C L_out
                           i, i, i,                # K_up stride pad
                           i, f, i, f,             # in/out leaky
                           i, i, i, p,             # n_rb n_dmax kr dils
                           i, i, i, i, i, i, i,    # halo tile ss kc stages nt mt
                           i, p]                   # smem stream
            cl_args = [i, i, i, i]                 # n_rb nt mt smem
        fn.restype = i
        stage[tag] = fn
        fn = getattr(lib, clusters_name)
        fn.argtypes = cl_args
        fn.restype = i
        clusters[tag] = fn
        if tag == "f32":
            error_string = lib.zv_cuda_error_string
            error_string.argtypes = [i]
            error_string.restype = ctypes.c_char_p
    return Library(stage, clusters, error_string, log, seconds, probe, lbo_is_k)


@functools.lru_cache(maxsize=None)
def wave_clusters(device_index: int, n_rb: int, C: int, mode: str = "f32",
                  mt: int = 0) -> int:
    """Clusters of n_rb CTAs of the mode's kernel (kernel_mode) for C
    channels that the card holds at once (one wave), from
    cudaOccupancyMaxActiveClusters at the shared memory a CTA may use (the
    bf16 and f16-staged modes: of the instance with mt M-tiles per
    warpgroup)."""
    lib = library()
    with torch.cuda.device(device_index):
        if mode in _WGMMA_MODES:
            n = lib.max_clusters[mode](n_rb, C, mt,
                                       _SMEM_MAX if mt * C > 128 else _SMEM_2)
        else:
            nt, mt, _ = warp_grid(C)
            n = lib.max_clusters[mode](n_rb, nt, mt, _SMEM_MAX)
    if n <= 0:
        raise RuntimeError(f"mrf_stage kernel: no cluster of {n_rb} CTAs fits the card: "
                           f"{lib.error_string(-n).decode() if n else 'none'}")
    return n


def wgmma_probe(device, shift: int, lbo_k: int, rows: int = 72, seed: int = 0,
                mode: str = "bf16"):
    """Run a wgmma mode's descriptor probe on the card (mode "bf16": bf16
    operands; "f16_staged": that library's f16 ones): one warpgroup
    computes A[shift : shift + 64] @ B^T (A: rows x 16, B: 32 x 16, random
    values of the operand type from `seed`) with A read through a
    no-swizzle descriptor whose start is `shift` rows into a plane, LBO
    holding the offset between the k halves (lbo_k = 1) or between 8-row
    groups (0; SBO the other; the stage kernel's choice is
    library().lbo_is_k).  Returns the card's (64, 32) float32 result and
    the plain product of the same values."""
    op = torch.float16 if mode == "f16_staged" else torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(rows, 16, generator=g).to(op).to(device)
    b = torch.randn(32, 16, generator=g).to(op).to(device)
    d = torch.empty(64, 32, device=device)
    lib = library()
    with torch.cuda.device(device):
        err = lib.probe[mode](a.data_ptr(), b.data_ptr(), d.data_ptr(), rows, shift, lbo_k,
                              torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma probe launch failed: {lib.error_string(err).decode()} ({err})")
    return d, a[shift:shift + 64].float() @ b.float().T


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernel reads and writes 16-byte groups)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def swizzle_rows(w: torch.Tensor) -> torch.Tensor:
    """w[..., ci, co] moved to column co ^ 8 * (ci % 4) of its row (an
    involution; the identity unless the row length is a multiple of 32)."""
    C = w.shape[-1]
    if C % 32:
        return w
    ci = torch.arange(w.shape[-2], device=w.device)
    col = torch.arange(C, device=w.device)[None, :] ^ ((ci[:, None] & 3) << 3)
    return w.gather(-1, col.expand(w.shape))


class PackedStage(NamedTuple):
    """A stage's weights in the kernel's layout (pack_stage)."""
    w: torch.Tensor                  # f32: (n_conv, K, C, C) [k][ci][swizzled co], chain
    #                                  order; bf16 and f16-staged (f16 values): (n_conv, K,
    #                                  C/8, C, 8) [k][ci/8][co][ci%8], planes of 8 input channels
    b: torch.Tensor                  # (n_conv, C) float32 in every mode
    w_up: Optional[torch.Tensor]     # ConvTranspose1d taps: f32 (K_up, C_pre, C) [k][ci][co];
    #                                  bf16 and f16-staged (K_up, C_pre/8, C, 8) [k][ci/8][co][ci%8]
    staged: bool = False             # w and w_up f16 planes (the f16-staged mode)


def to_planes(w: torch.Tensor) -> torch.Tensor:
    """w[..., ci, co] as planes of 8 input channels, [..., ci // 8, co, ci % 8]:
    the wgmma kernel's shared-memory layout of a weight chunk (a plane: C
    rows of 16 bytes of bf16 or f16 values, one core matrix of a wgmma B
    operand per 8 rows)."""
    *lead, cin, cout = w.shape
    return w.reshape(*lead, cin // 8, 8, cout).transpose(-1, -2).contiguous()


def from_planes(w: torch.Tensor) -> torch.Tensor:
    """The inverse of to_planes: [..., ci // 8, co, ci % 8] -> [..., ci, co]."""
    *lead, g, cout, eight = w.shape
    return w.transpose(-1, -2).reshape(*lead, g * eight, cout)


def pack_stage(blocks: Sequence[dict], dilation_sets: Sequence[Sequence[int]],
               kernel_size: int, upsample_w: Optional[torch.Tensor] = None) -> PackedStage:
    """The kernel's weight layout for one stage, made once per model.

    blocks' (Cout, Cin, K) convs go to [k][ci][co ^ 8 * (ci % 4)] in chain
    order (resblock, dilation, then convs1 before convs2): rows of C floats,
    so a weight chunk (a tap, consecutive input channels) is one contiguous
    copy, with the output channel swizzled so that the kernel's loads of
    four consecutive rows hit distinct shared-memory banks (C % 32 == 0;
    other C keep co in place).  The flipped (C, C_pre, K) export upsample
    kernel goes to PyTorch's unflipped taps as [k][ci][co].

    bf16 weights (C and the upsample's input channels multiples of 8) go to
    planes of 8 input channels (to_planes): conv taps [k][ci/8][co][ci%8],
    upsample taps [k][ci/8][co][ci%8], so a chunk of the bf16 kernel's
    weight stream (one tap, consecutive input channels) is one contiguous
    copy already in the layout its wgmma descriptors read.  The biases are
    widened to float32 (exact): the kernel adds them in f32.

    Under f16_staging, float32 weights are packed for the f16-staged mode,
    whose kernel has the bf16 mode's design: the convs' and the upsample's
    rounded to f16 (round_f16, to nearest even) as f16 planes, the same
    layout with f16 values; the biases float32 as they are
    (PackedStage.staged)."""
    C = blocks[0]["convs1"][0]["w"].shape[0]
    dev = blocks[0]["convs1"][0]["w"].device
    dtype = blocks[0]["convs1"][0]["w"].dtype
    _check_dtypes(dtype, blocks, None if upsample_w is None else dict(w=upsample_w))
    mode = kernel_mode(dtype)
    staged = mode == "f16_staged"
    planes = mode in _WGMMA_MODES
    if planes and (C % 8 or (upsample_w is not None and upsample_w.shape[1] % 8)):
        raise ValueError(f"{mode} weights pack planes of 8 input channels: C={C}"
                         + ("" if upsample_w is None else f", upsample {upsample_w.shape[1]}"))
    op = torch.float16 if staged else dtype
    ws, bs = [], []
    for j, blk in enumerate(blocks):
        for di in range(len(dilation_sets[j])):
            for cset in ("convs1", "convs2"):
                conv = blk[cset][di]
                if tuple(conv["w"].shape) != (C, C, kernel_size):
                    raise ValueError(f"block {j} {cset}[{di}] weight has shape "
                                     f"{tuple(conv['w'].shape)}, want {(C, C, kernel_size)}")
                if conv["w"].device != dev or conv["b"].device != dev:
                    raise ValueError(f"block {j} {cset}[{di}] lies on {conv['w'].device}, "
                                     f"block 0 on {dev}")
                w = conv["w"].permute(2, 1, 0)                      # [k][ci][co]
                ws.append(to_planes(w.to(op)) if planes else swizzle_rows(w))
                bs.append(conv["b"].to(torch.float32))
    w_up = (None if upsample_w is None
            else unflip_transpose_weight(upsample_w).permute(2, 0, 1).contiguous())
    if planes and w_up is not None:
        w_up = to_planes(w_up.to(op))
    return PackedStage(torch.stack(ws).contiguous(), torch.stack(bs).contiguous(), w_up,
                       staged)


def stage_plan(device: torch.device, C: int, dilation_sets, kernel_size: int, B: int,
               L_out: int, up_cin: int = 0, up_k: int = 0, up_stride: int = 1,
               dtype: torch.dtype = torch.float32, mode: Optional[str] = None,
               **change) -> TilePlan:
    """The plan a launch on `device` uses in `mode` (default: the mode of
    `dtype` in the calling context, kernel_mode): tile_plan (bfloat16 and
    f16-staged: bf16_plan, the wgmma design's geometry) with the card's own
    wave of clusters (`change`: tile_plan's kc / stages, bf16_plan's window
    / stages)."""
    mode = mode or kernel_mode(dtype)
    wgmma = mode in _WGMMA_MODES
    # a geometry the mode does not take raises here, before the card is asked
    mt = 0
    if wgmma:
        mt = bf16_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, **change).mt
    else:
        warp_grid(C)
    wave = wave_clusters(torch.device(device).index or 0, len(dilation_sets), C, mode, mt)
    if wgmma:
        return bf16_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave,
                         **change)
    return tile_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave,
                     **change)


def _launch(x, blocks, dilation_sets, kernel_size, upsample, in_bias,
            in_leaky, out_leaky, packed: Optional[PackedStage],
            plan: Optional[TilePlan] = None, counter=None) -> torch.Tensor:
    """Check the arguments and launch the kernel once (packing the weights
    first when the caller did not), in the mode of x's dtype in the calling
    context (kernel_mode), and count the launch in `counter` (a wrapper).
    plan: a geometry other than stage_plan's, for measuring variants."""
    dtype = x.dtype
    _check_dtypes(dtype, blocks, upsample)
    mode = kernel_mode(dtype)
    staged = mode == "f16_staged"
    wgmma = mode in _WGMMA_MODES
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("mrf_stage kernel takes a contiguous (B, L, C) tensor")
    if kernel_size % 2 != 1:
        raise ValueError(f"resblock kernel size must be odd, got {kernel_size}")
    if not 1 <= len(blocks) <= _MAX_RB or len(dilation_sets) < len(blocks) \
            or any(not 1 <= len(d) <= _MAX_D for d in dilation_sets[:len(blocks)]):
        raise ValueError("mrf_stage kernel takes 1-8 resblocks of 1-8 dilations")
    dilation_sets = [tuple(int(d) for d in ds) for ds in dilation_sets[:len(blocks)]]
    if any(d < 1 for ds in dilation_sets for d in ds):
        raise ValueError("dilations must be >= 1")
    if packed is None:
        packed = pack_stage(blocks, dilation_sets, kernel_size,
                            None if upsample is None else upsample["w"])
    if packed.staged != staged:
        raise ValueError(f"mrf_stage: weights packed {'with' if packed.staged else 'without'} "
                         f"f16 staging for a launch {'under' if staged else 'outside'} "
                         f"f16_staging; pack them under the launch's f16_staging")
    dev = x.device
    B, L_in, Cin = x.shape
    C = blocks[0]["convs1"][0]["w"].shape[0]
    n_conv = sum(2 * len(ds) for ds in dilation_sets)
    halo = stage_halo(dilation_sets, kernel_size)
    w_shape = ((n_conv, kernel_size, C // 8, C, 8) if wgmma
               else (n_conv, kernel_size, C, C))
    if tuple(packed.w.shape) != w_shape or tuple(packed.b.shape) != (n_conv, C):
        raise ValueError(f"packed weights {tuple(packed.w.shape)} / {tuple(packed.b.shape)} "
                         f"do not match {n_conv} convs of {C} channels")

    K_up = stride = pad = 0
    if upsample is not None:
        if packed.w_up is None:
            raise ValueError("upsample= needs packed weights with w_up")
        K_up, cin_up, c_up = ((packed.w_up.shape[0], 8 * packed.w_up.shape[1],
                               packed.w_up.shape[2]) if wgmma else packed.w_up.shape)
        if c_up != C or cin_up != Cin:
            raise ValueError(f"upsample weight maps {cin_up} -> {c_up} channels, "
                             f"the stage {Cin} -> {C}")
        group = 8 if wgmma else 4              # 16 bytes of operands / of f32 input
        if Cin % group:
            raise ValueError(f"mrf_stage kernel: the upsample's input channels ({Cin}) "
                             f"must be a multiple of {group}")
        stride, pad = int(upsample["stride"]), int(upsample["padding"])
        opad = int(upsample["output_padding"])
        if stride < 1 or not 0 <= opad < stride:
            raise ValueError(f"output_padding ({opad}) must be < stride ({stride})")
        L_out = transpose_out_len(L_in, stride, K_up, pad, opad)
    else:
        if Cin != C:
            raise ValueError(f"input has {Cin} channels, the stage {C}")
        L_out = L_in
    if L_out < 1 or B < 1:
        raise ValueError(f"empty stage: B={B}, L_out={L_out}")
    if plan is None:
        plan = stage_plan(dev, C, dilation_sets, kernel_size, B, L_out,
                          Cin if upsample is not None else 0, K_up, stride, dtype, mode)
    ib = None if in_bias is None else _aligned(in_bias.to(dev, torch.float32).contiguous())
    if ib is not None and ib.shape != (C,):
        raise ValueError(f"in_bias has shape {tuple(ib.shape)}, want ({C},)")
    x = _aligned(x)
    w_up = _aligned(packed.w_up) if upsample is not None else None
    w, b = _aligned(packed.w), _aligned(packed.b)
    op = torch.float16 if staged else dtype
    for t, want in ((w_up, op), (w, op), (b, torch.float32)):
        if t is not None and (t.device != dev or t.dtype != want or not t.is_contiguous()):
            raise TypeError(f"mrf_stage kernel: packed weights must be contiguous {op} "
                            f"(biases float32) on the input's device")

    n_dmax = max(len(d) for d in dilation_sets)
    dils = (ctypes.c_int * (len(blocks) * n_dmax))(
        *[ds[i] if i < len(ds) else 0 for ds in dilation_sets for i in range(n_dmax)])
    y = torch.empty(B, L_out, C, device=dev, dtype=dtype)
    lib = library()
    if wgmma:
        geometry = (halo, plan.tile, plan.window, plan.margin, plan.plane_rows, plan.np_rows,
                    plan.buf, plan.kb, plan.mt, plan.stages)
    else:
        geometry = (halo, plan.tile, plan.ss, plan.kc, plan.stages, plan.nt, plan.mt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stage[mode](
            x.data_ptr(), _ptr(w_up), _ptr(ib), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), B, L_in, Cin, C, L_out, K_up, stride, pad,
            int(in_leaky is not None), float(in_leaky or 0.0),
            int(out_leaky is not None), float(out_leaky or 0.0),
            len(blocks), n_dmax, kernel_size, dils, *geometry, plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"mrf_stage kernel launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")
    if counter is not None:
        _count_launch(counter, mode)
    return y


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def refuse_autograd(x: torch.Tensor, blocks: Sequence[dict],
                    upsample: Optional[dict] = None,
                    in_bias: Optional[torch.Tensor] = None):
    """Raise RuntimeError if autograd is on and the stage input, a resblock
    weight or bias, the upsample weight or in_bias requires a gradient: the
    kernel writes into a fresh tensor with no grad_fn, so its result would
    silently cut the graph there.  The wrappers call it before they launch."""
    if not torch.is_grad_enabled():
        return
    tensors = [x, in_bias, None if upsample is None else upsample["w"]]
    tensors += [c[k] for blk in blocks for cs in ("convs1", "convs2")
                for c in blk[cs] for k in ("w", "b")]
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "mrf_stage: the CUDA kernel has no backward, and a tensor of this stage requires "
            "a gradient; differentiate through the plain version instead "
            "(hifigan.vocode(..., differentiable=True), which runs mrf_stage_ref), or call "
            "under torch.no_grad()")


def mrf_stage(x: torch.Tensor,
              blocks: Sequence[dict],
              dilation_sets: Sequence[Sequence[int]],
              kernel_size: int,
              upsample: Optional[dict] = None,
              in_bias: Optional[torch.Tensor] = None,
              in_leaky: Optional[float] = None,
              out_leaky: Optional[float] = None,
              packed: Optional[PackedStage] = None) -> torch.Tensor:
    """One fused MRF stage on channels-last activations.

    x: (B, L, C) stage input, or with `upsample` the pre-upsample activation
    (B, L_pre, C_pre).  upsample: dict(w=(C, C_pre, K) flipped export kernel,
    stride, padding, output_padding); the output then has
    transpose_out_len(L_pre, ...) rows, any K.  in_leaky: slope of a leaky-
    relu on the pre-upsample input.  in_bias: (C,) added to the stage input.
    out_leaky: slope of a leaky-relu on the stage output.
    blocks[j] = {"convs1": [{"w", "b"}...], "convs2": [...]} with (C, C, K)
    weights; dilation_sets[j] the convs1 dilations of resblock j.
    packed: the same weights in the kernel's layout (pack_stage), made once
    per model so that a launch moves no weights; packed here when omitted.
    The plain version (CPU tensors) reads `blocks` and `upsample` only.

    Returns (1/n) * sum_j resblock_j(input), (B, L_out, C) in x's dtype
    (float32 or bfloat16; the weights must have the same).  Under
    ops.conv.f16_staging a float32 call computes the f16-staged stage (on
    a card the kernel's f16-staged mode; packed must then be staged too),
    and a bfloat16 call raises.
    """
    if x.device.type == "cpu":
        return mrf_stage_ref(x, blocks, dilation_sets, kernel_size,
                             upsample=upsample, in_bias=in_bias,
                             in_leaky=in_leaky, out_leaky=out_leaky)
    _check_options(upsample, in_leaky)
    refuse_autograd(x, blocks, upsample, in_bias)
    return _launch(x, blocks, dilation_sets, kernel_size, upsample, in_bias,
                   in_leaky, out_leaky, packed, counter=mrf_stage)


mrf_stage.launches = 0
mrf_stage.staged_launches = 0


def mrf_stage_unfolded(x: torch.Tensor,
                       blocks: Sequence[dict],
                       dilation_sets: Sequence[Sequence[int]],
                       kernel_size: int,
                       packed: Optional[PackedStage] = None) -> torch.Tensor:
    """The MRF stage on (B, L, C) with no fused options: the same kernel as
    mrf_stage, counted in `mrf_stage_unfolded.launches` (those in the
    f16-staged mode also in `mrf_stage_unfolded.staged_launches`)."""
    if x.device.type == "cpu":
        return mrf_stage_ref(x, blocks, dilation_sets, kernel_size)
    refuse_autograd(x, blocks)
    return _launch(x, blocks, dilation_sets, kernel_size, None, None, None, None, packed,
                   counter=mrf_stage_unfolded)


mrf_stage_unfolded.launches = 0
mrf_stage_unfolded.staged_launches = 0
