"""The vocoder's fused MRF stage: the hand-written CUDA kernel and its plain version.

`mrf_stage` is the port of zerovox_tpu/ops/pallas/folded_mrf.py's
`folded_mrf_stage` (the TPU kernel `_mrf_kernel`): one whole HiFi-GAN
multi-receptive-field stage, optionally with the preceding ConvTranspose1d
upsample, its bias and the leaky-relus on either side fused in.
`mrf_stage_unfolded` is the same kernel with every option off, the port of
`mrf_stage_unfolded`.  The kernel source is zerovox_tpu_torch/csrc/mrf_stage.cu.

For a CUDA tensor the wrappers launch the kernel or raise; they take the
plain version (`mrf_stage_ref`, built from F.conv1d / F.conv_transpose1d)
only for tensors that lie on the CPU.  Each wrapper counts its kernel
launches in a plain integer attribute (`mrf_stage.launches`).  The kernel
reads its weights in its own layout (`pack_stage`), which a serving caller
makes once per model and passes as `packed=`.

The kernel is compiled with nvcc, at its first CUDA call (never at import),
into build/zerovox_tpu_torch/ at the root of the checkout, as a shared
library with a plain C interface loaded through ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import torch

from ..conv import conv1d, conv_transpose1d, transpose_out_len, unflip_transpose_weight
from ..misc import leaky_relu

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "mrf_stage.cu"
BUILD_DIR = _PKG.parent / "build" / "zerovox_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Limits shared with csrc/mrf_stage.cu (which rejects a geometry that breaks them)
_WARPS = 8                # warps per CTA
_CHUNK_FLOATS = 3072      # floats per streamed weight chunk (at most)
_MAX_RB = 8               # resblocks per stage
_MAX_D = 8                # dilations per resblock
_SMEM_MAX = 232448        # dynamic shared memory one CTA may use (bytes)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def residual_block(x: torch.Tensor, p: dict, dilations, kernel_size: int) -> torch.Tensor:
    """Multi-dilation residual block: per dilation d,
    x += conv2(leaky(conv1_d(leaky(x), dil=d), 0.1)) (both with bias)."""
    half_k = (kernel_size - 1) // 2
    for d_idx, dilation in enumerate(dilations):
        c1 = p["convs1"][d_idx]
        c2 = p["convs2"][d_idx]
        xt = leaky_relu(x, 0.1)
        xt = conv1d(xt, c1["w"], c1["b"], padding=half_k * dilation,
                    dilation=dilation)
        xt = leaky_relu(xt, 0.1)
        xt = conv1d(xt, c2["w"], c2["b"], padding=half_k)
        x = x + xt
    return x


def mrf_stage_ref(x: torch.Tensor,
                  blocks: Sequence[dict],
                  dilation_sets: Sequence[Sequence[int]],
                  kernel_size: int,
                  upsample: Optional[dict] = None,
                  in_bias: Optional[torch.Tensor] = None,
                  in_leaky: Optional[float] = None,
                  out_leaky: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the fused stage (same arguments as mrf_stage)."""
    _check_options(upsample, in_leaky)
    if upsample is not None:
        if in_leaky is not None:
            x = leaky_relu(x, in_leaky)
        x = conv_transpose1d(x, upsample["w"], None, stride=upsample["stride"],
                             padding=upsample["padding"],
                             output_padding=upsample["output_padding"])
    if in_bias is not None:
        x = x + in_bias
    acc = None
    for j, blk in enumerate(blocks):
        r = residual_block(x, blk, dilation_sets[j], kernel_size)
        acc = r if acc is None else acc + r
    out = acc * (1.0 / len(blocks))
    if out_leaky is not None:
        out = leaky_relu(out, out_leaky)
    return out


def _check_options(upsample, in_leaky):
    if in_leaky is not None and upsample is None:
        raise ValueError("in_leaky acts on the pre-upsample input; it needs upsample=")


# --------------------------------------------------------------------------
# launch geometry (plain Python, so the CPU tests reach it)
# --------------------------------------------------------------------------

def stage_halo(dilation_sets: Sequence[Sequence[int]], kernel_size: int) -> int:
    """Per-side receptive field (rows) of the worst resblock of one stage:
    12 at k=3 and dilations (1, 3, 5)."""
    half = (kernel_size - 1) // 2
    return max(sum(half * (d + 1) for d in dils) for dils in dilation_sets)


class TilePlan(NamedTuple):
    tile: int        # output rows per CTA
    ss: int          # shared-memory row stride (floats, odd)
    ch: int          # input channels per streamed weight chunk
    tn: int          # output channels per thread tile (8, or 4 where C % 8)
    wc: int          # thread columns per warp (rows: 32 // wc)
    smem: int        # dynamic shared memory per CTA (bytes)


def tile_plan(C: int, halo: int, kernel_size: int = 3, min_first_dilation: int = 1,
              up_cin: int = 0, up_k: int = 0, up_stride: int = 1) -> TilePlan:
    """Launch geometry for a stage of C channels (csrc/mrf_stage.cu).

    Shared memory holds two weight chunks (kernel_size x ch x C floats each,
    at most 12 KB) and three f32 windows of tile + 2*halo rows with an odd
    row stride (C + 1, so a warp's reads of neighbouring rows hit distinct
    banks).  Each conv of the chain must fit one round of the CTA's 8 warps,
    a warp covering 8*(32 // wc) rows x tn*wc channels; the tile is the
    longest that satisfies both.  Raises ValueError for a stage the kernel
    cannot hold."""
    if C % 4 or C < 4:
        raise ValueError(f"mrf_stage kernel needs C % 4 == 0, got C={C}")
    tn = 8 if C % 8 == 0 else 4
    groups = C // tn
    wc = next(w for w in (8, 4, 2, 1) if groups % w == 0)
    col_tiles = groups // wc
    if col_tiles > _WARPS:
        raise ValueError(f"mrf_stage kernel takes C <= {_WARPS * 8 * tn}, got C={C}")
    ch = min(C, max(1, _CHUNK_FLOATS // (kernel_size * C)))
    while C % ch:
        ch -= 1
    ss = C + 1
    half = (kernel_size - 1) // 2
    rows_round = (_WARPS // col_tiles) * 8 * (32 // wc)
    window = min(rows_round + 2 * half * min_first_dilation,
                 (_SMEM_MAX // 4 - 2 * kernel_size * ch * C) // (3 * ss))
    tile = window - 2 * halo
    if tile < 1:
        raise ValueError(f"mrf_stage kernel: C={C} with halo {halo} leaves no "
                         "room for a time tile")
    if up_cin:
        pre_rows = (window - 1 + up_k - 1) // up_stride + 2
        if pre_rows * up_cin > 2 * window * ss:
            raise ValueError(
                f"mrf_stage kernel: {pre_rows} pre-upsample rows of {up_cin} "
                "channels do not fit the staging buffers")
    smem = 4 * (2 * kernel_size * ch * C + 3 * window * ss)
    return TilePlan(tile, ss, ch, tn, wc, smem)


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


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library.

    The library's `build_log` attribute holds nvcc's output (ptxas register
    and shared-memory report) and `build_seconds` the compile time (0 when
    an earlier build of the same source was reused)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"mrf_stage_{digest}.so"
    log, seconds = "", 0.0
    if not so.exists():
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, so)
        log, seconds = proc.stdout + proc.stderr, time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zv_mrf_stage_f32.argtypes = [p, p, p, p, p, p,       # x w_up in_bias w b y
                                     i, i, i, i, i,          # B L_in Cin C L_out
                                     i, i, i,                # K_up stride pad
                                     i, f, i, f,             # in/out leaky
                                     i, i, i, p,             # n_rb n_dmax kr dils
                                     i, i, i, i, i, i, i, p]  # halo tile ss ch wc tn smem stream
    lib.zv_mrf_stage_f32.restype = i
    lib.zv_cuda_error_string.argtypes = [i]
    lib.zv_cuda_error_string.restype = ctypes.c_char_p
    lib.build_log, lib.build_seconds = log, seconds
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class PackedStage(NamedTuple):
    """A stage's weights in the kernel's layout (pack_stage)."""
    w: torch.Tensor                  # (n_conv, K, C, C) [k][ci][co], chain order
    b: torch.Tensor                  # (n_conv, C)
    w_up: Optional[torch.Tensor]     # (K_up, C_pre, C) [k][ci][co] ConvTranspose1d taps


def pack_stage(blocks: Sequence[dict], dilation_sets: Sequence[Sequence[int]],
               kernel_size: int, upsample_w: Optional[torch.Tensor] = None
               ) -> PackedStage:
    """The kernel's weight layout for one stage, made once per model.

    blocks' (Cout, Cin, K) convs go to [k][ci][co] in chain order (resblock,
    dilation, then convs1 before convs2); the flipped (C, C_pre, K) export
    upsample kernel goes to PyTorch's unflipped taps as [k][ci][co]."""
    C = blocks[0]["convs1"][0]["w"].shape[0]
    dev = blocks[0]["convs1"][0]["w"].device
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
                ws.append(conv["w"].permute(2, 1, 0))
                bs.append(conv["b"])
    w_up = (None if upsample_w is None
            else unflip_transpose_weight(upsample_w).permute(2, 0, 1).contiguous())
    return PackedStage(torch.stack(ws).contiguous(), torch.stack(bs).contiguous(), w_up)


def _launch(x, blocks, dilation_sets, kernel_size, upsample, in_bias,
            in_leaky, out_leaky, packed: Optional[PackedStage]) -> torch.Tensor:
    """Check the arguments and launch the kernel once (packing the weights
    first when the caller did not)."""
    if x.dtype != torch.float32:
        raise TypeError(f"mrf_stage kernel takes float32, got {x.dtype}")
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
    dev = x.device
    B, L_in, Cin = x.shape
    C = blocks[0]["convs1"][0]["w"].shape[0]
    n_conv = sum(2 * len(ds) for ds in dilation_sets)
    halo = stage_halo(dilation_sets, kernel_size)
    min_d1 = min(ds[0] for ds in dilation_sets)
    if tuple(packed.w.shape) != (n_conv, kernel_size, C, C) \
            or tuple(packed.b.shape) != (n_conv, C):
        raise ValueError(f"packed weights {tuple(packed.w.shape)} / {tuple(packed.b.shape)} "
                         f"do not match {n_conv} convs of {C} channels")

    K_up = stride = pad = 0
    if upsample is not None:
        if packed.w_up is None:
            raise ValueError("upsample= needs packed weights with w_up")
        K_up, cin_up, c_up = packed.w_up.shape
        if c_up != C or cin_up != Cin:
            raise ValueError(f"upsample weight maps {cin_up} -> {c_up} channels, "
                             f"the stage {Cin} -> {C}")
        stride, pad = int(upsample["stride"]), int(upsample["padding"])
        opad = int(upsample["output_padding"])
        if stride < 1 or not 0 <= opad < stride:
            raise ValueError(f"output_padding ({opad}) must be < stride ({stride})")
        L_out = transpose_out_len(L_in, stride, K_up, pad, opad)
        plan = tile_plan(C, halo, kernel_size, min_d1, Cin, K_up, stride)
    else:
        if Cin != C:
            raise ValueError(f"input has {Cin} channels, the stage {C}")
        L_out = L_in
        plan = tile_plan(C, halo, kernel_size, min_d1)
    if L_out < 1 or B < 1:
        raise ValueError(f"empty stage: B={B}, L_out={L_out}")
    ib = None if in_bias is None else in_bias.to(dev, torch.float32).contiguous()
    if ib is not None and ib.shape != (C,):
        raise ValueError(f"in_bias has shape {tuple(ib.shape)}, want ({C},)")
    w_up = packed.w_up if upsample is not None else None
    for t in (w_up, packed.w, packed.b):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise TypeError("mrf_stage kernel: weights must be contiguous float32 "
                            "on the input's device")

    n_dmax = max(len(d) for d in dilation_sets)
    dils = (ctypes.c_int * (len(blocks) * n_dmax))(
        *[ds[i] if i < len(ds) else 0 for ds in dilation_sets for i in range(n_dmax)])
    y = torch.empty(B, L_out, C, device=dev, dtype=torch.float32)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zv_mrf_stage_f32(
            x.data_ptr(), _ptr(w_up), _ptr(ib), packed.w.data_ptr(), packed.b.data_ptr(),
            y.data_ptr(), B, L_in, Cin, C, L_out, K_up, stride, pad,
            int(in_leaky is not None), float(in_leaky or 0.0),
            int(out_leaky is not None), float(out_leaky or 0.0),
            len(blocks), n_dmax, kernel_size, dils,
            halo, plan.tile, plan.ss, plan.ch, plan.wc, plan.tn, plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"mrf_stage kernel launch failed: "
                           f"{lib.zv_cuda_error_string(err).decode()} ({err})")
    return y


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

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

    Returns (1/n) * sum_j resblock_j(input), (B, L_out, C) float32.
    """
    if x.device.type == "cpu":
        return mrf_stage_ref(x, blocks, dilation_sets, kernel_size,
                             upsample=upsample, in_bias=in_bias,
                             in_leaky=in_leaky, out_leaky=out_leaky)
    _check_options(upsample, in_leaky)
    y = _launch(x, blocks, dilation_sets, kernel_size, upsample, in_bias,
                in_leaky, out_leaky, packed)
    mrf_stage.launches += 1
    return y


mrf_stage.launches = 0


def mrf_stage_unfolded(x: torch.Tensor,
                       blocks: Sequence[dict],
                       dilation_sets: Sequence[Sequence[int]],
                       kernel_size: int,
                       packed: Optional[PackedStage] = None) -> torch.Tensor:
    """The MRF stage on (B, L, C) with no fused options: the same kernel as
    mrf_stage, counted in `mrf_stage_unfolded.launches`."""
    if x.device.type == "cpu":
        return mrf_stage_ref(x, blocks, dilation_sets, kernel_size)
    y = _launch(x, blocks, dilation_sets, kernel_size, None, None, None, None, packed)
    mrf_stage_unfolded.launches += 1
    return y


mrf_stage_unfolded.launches = 0
