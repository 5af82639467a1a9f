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

The kernel runs each conv on the tensor cores at f32 accuracy (3xTF32:
`split_tf32` mirrors its operand split), one resblock per CTA in a cluster
of one CTA per resblock; `tile_plan` chooses its geometry in plain Python,
so the CPU tests reach it.  It takes C in 32/64/128/256/512.

The kernel is compiled with nvcc, at its first CUDA call (never at import),
into build/zerovox_tpu_torch/ at the root of the checkout, as a shared
library with a plain C interface loaded through ctypes.
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
_STAGES = 3               # weight ring depth (chunks in flight)
_CHUNK_FLOATS = 8192      # weight chunk target: one tap x kc input channels x C
_MAX_RB = 8               # resblocks per stage (= CTAs per cluster)
_MAX_D = 8                # dilations per resblock
_SMEM_MAX = 232448        # dynamic shared memory one CTA may use (bytes)
_SMS = 132                # streaming multiprocessors of an H100 SXM
_MT = {8: 3, 4: 6}        # kernel instances: n8 column tiles per warp -> m16 row tiles
_KC = {8: (16, 32, 64), 4: (16, 32)}   # ... and their weight chunks (input channels)


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
    tile: int        # output rows per cluster (its CTAs run one resblock each)
    clusters: int    # clusters per launch (B x time tiles); 0 with no L_out
    ss: int          # window row stride (floats, C + 4)
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


def _geometry(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, kc,
              stages):
    nt, mt, warps_m = warp_grid(C)
    if kc not in _KC[nt] or C % kc or not 2 <= stages <= 8:
        raise ValueError(f"mrf_stage kernel: chunks of {kc} channels (one of {_KC[nt]}, "
                         f"dividing C={C}) in a ring of 2-8, got a ring of {stages}")
    halo = stage_halo(dilation_sets, kernel_size)
    half = (kernel_size - 1) // 2
    ss = C + 4
    ring = stages * kc * C
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
    if up_cin and ((tile + 2 * halo + up_k - 2) // up_stride + 2) * up_cin \
            > (tile + 2 * halo) * ss:
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
    plans = []
    for k in _KC[nt]:
        if k <= max(_CHUNK_FLOATS // C, _KC[nt][0]) and C % k == 0:
            with contextlib.suppress(ValueError):
                plans.append(_geometry(*args, k, stages))
    if not plans:
        raise ValueError(f"mrf_stage kernel: no weight chunk of {_KC[nt]} channels fits C={C}")
    # the largest chunk whose tile is within a tenth of the longest any chunk
    # gives: a smaller ring lengthens the tile where shared memory sets it
    # (fewer recomputed halo rows, fewer waves), at the cost of more chunks
    longest = max(p.tile for p in plans)
    return [p for p in plans if 1.1 * p.tile >= longest][-1]


def tile_plan(C: int, dilation_sets: Sequence[Sequence[int]], kernel_size: int = 3,
              up_cin: int = 0, up_k: int = 0, up_stride: int = 1, B: int = 1,
              L_out: Optional[int] = None, wave: Optional[int] = None,
              kc: Optional[int] = None, stages: Optional[int] = None) -> TilePlan:
    """Launch geometry for a stage of C channels (csrc/mrf_stage.cu).

    A cluster of len(dilation_sets) CTAs takes one time tile, a CTA per
    resblock.  Shared memory holds the weight ring (`stages` chunks of
    kc x C floats) and two f32 windows of tile + 2*halo rows of C + 4
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
    dils = tuple(tuple(int(d) for d in ds) for ds in dilation_sets)
    wave = wave or max(1, _SMS // len(dils))
    return _plan(C, dils, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, kc, stages)


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
                                     i, i, i, i, i, i, i,    # halo tile ss kc stages nt mt
                                     i, p]                   # smem stream
    lib.zv_mrf_stage_f32.restype = i
    lib.zv_mrf_max_clusters.argtypes = [i, i, i, i]
    lib.zv_mrf_max_clusters.restype = i
    lib.zv_cuda_error_string.argtypes = [i]
    lib.zv_cuda_error_string.restype = ctypes.c_char_p
    lib.build_log, lib.build_seconds = log, seconds
    return lib


@functools.lru_cache(maxsize=None)
def wave_clusters(device_index: int, n_rb: int, nt: int, mt: int) -> int:
    """Clusters of n_rb CTAs that the card holds at once (one wave), from
    cudaOccupancyMaxActiveClusters at full shared memory."""
    lib = library()
    with torch.cuda.device(device_index):
        n = lib.zv_mrf_max_clusters(n_rb, nt, mt, _SMEM_MAX)
    if n <= 0:
        raise RuntimeError(f"mrf_stage kernel: no cluster of {n_rb} CTAs fits the card: "
                           f"{lib.zv_cuda_error_string(-n).decode() if n else 'none'}")
    return n


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernel reads and writes float4s)."""
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
    w: torch.Tensor                  # (n_conv, K, C, C) [k][ci][swizzled co], chain order
    b: torch.Tensor                  # (n_conv, C)
    w_up: Optional[torch.Tensor]     # (K_up, C_pre, C) [k][ci][co] ConvTranspose1d taps


def pack_stage(blocks: Sequence[dict], dilation_sets: Sequence[Sequence[int]],
               kernel_size: int, upsample_w: Optional[torch.Tensor] = None
               ) -> PackedStage:
    """The kernel's weight layout for one stage, made once per model.

    blocks' (Cout, Cin, K) convs go to [k][ci][co ^ 8 * (ci % 4)] in chain
    order (resblock, dilation, then convs1 before convs2): rows of C floats,
    so a weight chunk (a tap, consecutive input channels) is one contiguous
    copy, with the output channel swizzled so that the kernel's loads of
    four consecutive rows hit distinct shared-memory banks (C % 32 == 0;
    other C keep co in place).  The flipped (C, C_pre, K) export upsample
    kernel goes to PyTorch's unflipped taps as [k][ci][co]."""
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
                ws.append(swizzle_rows(conv["w"].permute(2, 1, 0)))
                bs.append(conv["b"])
    w_up = (None if upsample_w is None
            else unflip_transpose_weight(upsample_w).permute(2, 0, 1).contiguous())
    return PackedStage(torch.stack(ws).contiguous(), torch.stack(bs).contiguous(), w_up)


def stage_plan(device: torch.device, C: int, dilation_sets, kernel_size: int, B: int,
               L_out: int, up_cin: int = 0, up_k: int = 0, up_stride: int = 1,
               **change) -> TilePlan:
    """The tile plan a launch on `device` uses: tile_plan with the card's
    own wave of clusters (`change`: tile_plan's kc / stages)."""
    nt, mt, _ = warp_grid(C)
    wave = wave_clusters(torch.device(device).index or 0, len(dilation_sets), nt, mt)
    return tile_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave,
                     **change)


def _launch(x, blocks, dilation_sets, kernel_size, upsample, in_bias,
            in_leaky, out_leaky, packed: Optional[PackedStage],
            plan: Optional[TilePlan] = None) -> torch.Tensor:
    """Check the arguments and launch the kernel once (packing the weights
    first when the caller did not).  plan: a geometry other than
    stage_plan's, for measuring variants."""
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
        if Cin % 4:
            raise ValueError(f"mrf_stage kernel: the upsample's input channels ({Cin}) "
                             f"must be a multiple of 4")
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
                          Cin if upsample is not None else 0, K_up, stride)
    ib = None if in_bias is None else _aligned(in_bias.to(dev, torch.float32).contiguous())
    if ib is not None and ib.shape != (C,):
        raise ValueError(f"in_bias has shape {tuple(ib.shape)}, want ({C},)")
    x = _aligned(x)
    w_up = _aligned(packed.w_up) if upsample is not None else None
    w, b = _aligned(packed.w), _aligned(packed.b)
    for t in (w_up, w, b):
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
            x.data_ptr(), _ptr(w_up), _ptr(ib), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), B, L_in, Cin, C, L_out, K_up, stride, pad,
            int(in_leaky is not None), float(in_leaky or 0.0),
            int(out_leaky is not None), float(out_leaky or 0.0),
            len(blocks), n_dmax, kernel_size, dils,
            halo, plan.tile, plan.ss, plan.kc, plan.stages, plan.nt, plan.mt, plan.smem,
            stream)
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
