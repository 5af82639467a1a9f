"""The vocoder's fused MRF stage: the hand-written CUDA kernel and its plain version.

`mrf_stage` is the port of zerovox_tpu/ops/pallas/folded_mrf.py's
`folded_mrf_stage` (the TPU kernel `_mrf_kernel`): one whole HiFi-GAN
multi-receptive-field stage, optionally with the preceding ConvTranspose1d
upsample, its bias and the leaky-relus on either side fused in.
`mrf_stage_unfolded` is the same kernel with every option off, the port of
`mrf_stage_unfolded`.  The kernel source is zerovox_tpu_torch/csrc/mrf_stage.cu.

For a CUDA tensor the wrappers launch the kernel or raise; they take the
plain version (`mrf_stage_ref`, built from F.conv1d / F.conv_transpose1d)
only for tensors that lie on the CPU.  Which stages go to the kernel is the
caller's choice, made before any launch: `kernel_takes` says, in plain
Python, whether the kernel takes a stage's geometry (hifigan.vocode sends
the others to mrf_stage_ref on the card, as the JAX vocoder sends them to
XLA).  Each wrapper counts its kernel
launches in a plain integer attribute (`mrf_stage.launches`), added to under
a lock: a serving daemon launches from many threads.  The kernel
reads its weights in its own layout (`pack_stage`), which a serving caller
makes once per model and passes as `packed=`.

The kernel runs each conv on the tensor cores, one resblock per CTA in a
cluster of one CTA per resblock; `tile_plan` chooses its geometry in plain
Python, so the CPU tests reach it.  It takes C in 32/64/128/256/512 and two
modes, chosen by the input's dtype:

  float32   f32 accuracy (3xTF32: `split_tf32` mirrors its operand split);
  bfloat16  the serving mode (the TPU kernel's dot_bf16): input, output and
            weights are bf16 in device memory, every conv's operands are
            rounded to bf16 (after the leaky) for one bf16 MMA, and the
            accumulators, the biases, the residual and the resblock sum are
            f32; the result is rounded once, on the store.  `mrf_stage_ref`
            computes the same for bf16 tensors (`round_bf16` on each conv's
            operand, f32 convs on exactly representable products).

A bf16 input with f32 weights (or the reverse) raises.

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
library per mode (the same source, -DZV_MRF_BF16=0/1, both compiled at
once) with a plain C interface loaded through ctypes.  The build is guarded
by a lock: concurrent first calls (a server made without a warm-up) wait
for the one nvcc run.
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

from ..conv import conv1d, conv_transpose1d, transpose_out_len, unflip_transpose_weight
from ..misc import leaky_relu

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "mrf_stage.cu"
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
_KC = {8: (16, 32, 64), 4: (16, 32)}   # ... and their weight chunks (rows of 32-bit words:
#                                        input channels in f32, pairs of them in bf16)


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
    also float64): the input's."""
    allowed = (torch.float32, torch.bfloat16) + ((torch.float64,) if plain else ())
    if dtype not in allowed:
        raise TypeError(f"mrf_stage takes float32 or bfloat16, got {dtype}")
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
    tile: int        # output rows per cluster (its CTAs run one resblock each)
    clusters: int    # clusters per launch (B x time tiles); 0 with no L_out
    ss: int          # window row stride (floats: C + 4, C + 8 with 2-byte weights)
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


def chunk_channels(nt: int, elem: int):
    """The input channels a weight chunk of a kernel instance may hold:
    `elem`-byte weights fill the instance's rows of 32-bit words."""
    return tuple(k * 4 // elem for k in _KC[nt])


def _upsample_fits(tile, halo, up_cin, up_k, up_stride, ss) -> bool:
    """Whether the pre-upsample rows of a tile fit the conv1-output window
    that stages them (always, without an upsample)."""
    return not up_cin or ((tile + 2 * halo + up_k - 2) // up_stride + 2) * up_cin \
        <= (tile + 2 * halo) * ss


def _geometry(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, kc,
              stages, elem):
    nt, mt, warps_m = warp_grid(C)
    if kc not in chunk_channels(nt, elem) or C % kc or not 2 <= stages <= 8:
        raise ValueError(f"mrf_stage kernel: chunks of {kc} channels (one of "
                         f"{chunk_channels(nt, elem)}, dividing C={C}) in a ring of 2-8, "
                         f"got a ring of {stages}")
    halo = stage_halo(dilation_sets, kernel_size)
    half = (kernel_size - 1) // 2
    # the windows are f32 in both modes; the bf16 mode reads them in pairs of
    # channels, whose four rows per load need a stride of 8 mod 32 banks
    ss = C + (4 if elem == 4 else 8)
    ring = stages * kc * C * elem // 4            # 32-bit words
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
          stages, elem):
    if elem not in (2, 4):
        raise ValueError(f"mrf_stage kernel: 2-byte (bf16) or 4-byte (f32) weights, got {elem}")
    args = (C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave)
    stages = stages or _STAGES
    if kc:
        return _geometry(*args, kc, stages, elem)
    nt = warp_grid(C)[0]
    chunks = chunk_channels(nt, elem)
    plans = []
    for k in chunks:
        if k * elem // 4 <= max(_CHUNK_FLOATS // C, _KC[nt][0]) and C % k == 0:
            with contextlib.suppress(ValueError):
                plans.append(_geometry(*args, k, stages, elem))
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
              elem: int = 4) -> TilePlan:
    """Launch geometry for a stage of C channels (csrc/mrf_stage.cu).

    A cluster of len(dilation_sets) CTAs takes one time tile, a CTA per
    resblock.  Shared memory holds the weight ring (`stages` chunks of
    kc x C weights of `elem` bytes: 4 for the f32 mode, 2 for bf16) and two
    f32 windows of tile + 2*halo rows of C + 4 floats (C + 8 with 2-byte
    weights); the warps' row tiles must cover the first conv's rows, and the
    pre-upsample rows must fit the conv1-output window, which stages them.
    Without L_out the tile is the longest that fits.  With B and L_out it is
    the shortest tile that needs no more waves than the longest (a wave:
    `wave` clusters, by default 132 SMs // cluster size): where the longest
    tile leaves the card short of one wave, the tile shrinks until the grid
    fills it, and where it needs several, until the last wave is full; the
    extra halo rows cost less than the idle SMs.  The chunk (kc input
    channels, at most 8192 32-bit words: a bf16 chunk holds twice the
    channels of an f32 chunk of its bytes) is the largest of the kernel instance's
    whose tile is within a tenth of the longest tile any of them gives.  kc
    and stages replace the chunk and the ring depth (3), to measure
    variants.  Raises ValueError for a stage the kernel cannot hold."""
    dils = tuple(tuple(int(d) for d in ds) for ds in dilation_sets)
    wave = wave or max(1, _SMS // len(dils))
    return _plan(C, dils, kernel_size, up_cin, up_k, up_stride, B, L_out, wave, kc, stages,
                 elem)


def kernel_takes(C: int, dilation_sets: Sequence[Sequence[int]], kernel_size: int = 3,
                 up_cin: int = 0, up_k: int = 0, up_stride: int = 1,
                 dtype: torch.dtype = torch.float32) -> bool:
    """Whether the kernel takes a stage of this geometry in the mode of
    `dtype`, at any batch size and length: C channels, one resblock per
    entry of dilation_sets, and (up_cin > 0) an upsample of up_cin input
    channels, kernel up_k and stride up_stride.  Plain Python, so the CPU
    tests reach it; the vocoder runs a stage it does not take through the
    plain version (mrf_stage_ref), on the card too.  It asks what _launch
    and tile_plan ask: an odd kernel size, 1-8 resblocks of 1-8 dilations
    >= 1, a width and chunk the kernel's instances hold, upsample input
    channels in 16-byte groups, and a tile plan whose pre-upsample rows fit
    at every tile length a launch can choose (1 up to the longest)."""
    return _takes(C, tuple(tuple(int(d) for d in ds) for ds in dilation_sets), kernel_size,
                  up_cin, up_k, up_stride, dtype)


@functools.lru_cache(maxsize=256)
def _takes(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, dtype) -> bool:
    if dtype not in (torch.float32, torch.bfloat16) or kernel_size % 2 != 1 \
            or not 1 <= len(dilation_sets) <= _MAX_RB \
            or any(not 1 <= len(d) <= _MAX_D or min(d) < 1 for d in dilation_sets) \
            or (up_cin and up_cin % (16 // dtype.itemsize)):
        return False
    try:
        plan = tile_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride,
                         elem=dtype.itemsize)
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
    """The kernel's two builds and what nvcc said of them."""
    stage: dict            # torch dtype -> the mode's launch entry
    max_clusters: dict     # torch dtype -> the mode's cluster-occupancy entry
    error_string: object   # cudaGetErrorString
    build_log: str         # nvcc's output, both modes (ptxas registers and spills)
    build_seconds: float   # wall time of the compile, 0 when earlier builds were reused


_MODES = ((torch.float32, "f32", "zv_mrf_stage_f32", "zv_mrf_max_clusters"),
          (torch.bfloat16, "bf16", "zv_mrf_stage_bf16", "zv_mrf_max_clusters_bf16"))


_build_lock = threading.Lock()
_library: Optional[Library] = None
_count_lock = threading.Lock()


def library() -> Library:
    """The kernel's two libraries, built and loaded by the first call; calls
    that arrive while that one builds wait for it and build nothing."""
    global _library
    if _library is None:
        with _build_lock:
            if _library is None:
                _library = _build_library()
    return _library


def _count_launch(wrapper):
    """wrapper.launches += 1, under a lock (an unlocked += loses counts
    between threads)."""
    with _count_lock:
        wrapper.launches += 1


def _build_library() -> Library:
    """Build (once per source version) and load the kernel's two libraries,
    one per mode: the same source with -DZV_MRF_BF16=0 and =1, both nvcc
    runs started together."""
    from ...utils.compile_cache import build_dir, note_loaded
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for _, tag, _, _ in _MODES:
        so = out_dir / f"mrf_stage_{tag}_{digest}.so"
        if not so.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            procs[tag] = (so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, f"-DZV_MRF_BF16={int(tag == 'bf16')}", "-o", tmp,
                 str(SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    log, failed = "", ""
    for tag, (so, tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed += f"nvcc failed on {SOURCE} ({tag} mode):\n{err}\n"
            continue
        os.replace(tmp, so)
        log += f"[{tag}]\n{out}{err}"
    if failed:
        raise RuntimeError(failed)
    seconds = time.perf_counter() - t0 if procs else 0.0
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stage, clusters, error_string = {}, {}, None
    for dtype, tag, stage_name, clusters_name in _MODES:
        lib = ctypes.CDLL(str(out_dir / f"mrf_stage_{tag}_{digest}.so"))
        note_loaded(out_dir / f"mrf_stage_{tag}_{digest}.so")
        fn = getattr(lib, stage_name)
        fn.argtypes = [p, p, p, p, p, p,       # x w_up in_bias w b y
                       i, i, i, i, i,          # B L_in Cin C L_out
                       i, i, i,                # K_up stride pad
                       i, f, i, f,             # in/out leaky
                       i, i, i, p,             # n_rb n_dmax kr dils
                       i, i, i, i, i, i, i,    # halo tile ss kc stages nt mt
                       i, p]                   # smem stream
        fn.restype = i
        stage[dtype] = fn
        fn = getattr(lib, clusters_name)
        fn.argtypes = [i, i, i, i]
        fn.restype = i
        clusters[dtype] = fn
        if dtype == torch.float32:
            error_string = lib.zv_cuda_error_string
            error_string.argtypes = [i]
            error_string.restype = ctypes.c_char_p
    return Library(stage, clusters, error_string, log, seconds)


@functools.lru_cache(maxsize=None)
def wave_clusters(device_index: int, n_rb: int, nt: int, mt: int,
                  dtype: torch.dtype = torch.float32) -> int:
    """Clusters of n_rb CTAs of the mode's kernel that the card holds at
    once (one wave), from cudaOccupancyMaxActiveClusters at full shared
    memory."""
    lib = library()
    with torch.cuda.device(device_index):
        n = lib.max_clusters[dtype](n_rb, nt, mt, _SMEM_MAX)
    if n <= 0:
        raise RuntimeError(f"mrf_stage kernel: no cluster of {n_rb} CTAs fits the card: "
                           f"{lib.error_string(-n).decode() if n else 'none'}")
    return n


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
    #                                  order; bf16: (n_conv, K, C/2, C, 2) [k][ci/2][swizzled
    #                                  co][ci%2], a 32-bit word per pair of input channels
    b: torch.Tensor                  # (n_conv, C) float32 in both modes
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
    kernel goes to PyTorch's unflipped taps as [k][ci][co].

    bf16 weights (an even C) pack two consecutive input channels into one
    32-bit word, [k][ci/2][co ^ 8 * (ci/2 % 4)][ci%2]: a row of C words
    that the kernel addresses, swizzles and streams as it does an f32 row,
    and a word is one register of the bf16 MMA's B fragment.  The biases
    are widened to float32 (exact): the kernel adds them in f32."""
    C = blocks[0]["convs1"][0]["w"].shape[0]
    dev = blocks[0]["convs1"][0]["w"].device
    dtype = blocks[0]["convs1"][0]["w"].dtype
    _check_dtypes(dtype, blocks, None if upsample_w is None else dict(w=upsample_w))
    if dtype == torch.bfloat16 and C % 2:
        raise ValueError(f"bf16 weights pack pairs of input channels: C={C} is odd")
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
                if dtype == torch.bfloat16:
                    # words of (ci even, ci odd) per co, swizzled as words
                    w = w.reshape(kernel_size, C // 2, 2, C).permute(0, 1, 3, 2).contiguous()
                    w = swizzle_rows(w.view(torch.int32)[..., 0])
                    w = w.contiguous().view(kernel_size, C // 2, C, 1).view(torch.bfloat16)
                else:
                    w = swizzle_rows(w)
                ws.append(w)
                bs.append(conv["b"].to(torch.float32))
    w_up = (None if upsample_w is None
            else unflip_transpose_weight(upsample_w).permute(2, 0, 1).contiguous())
    return PackedStage(torch.stack(ws).contiguous(), torch.stack(bs).contiguous(), w_up)


def stage_plan(device: torch.device, C: int, dilation_sets, kernel_size: int, B: int,
               L_out: int, up_cin: int = 0, up_k: int = 0, up_stride: int = 1,
               dtype: torch.dtype = torch.float32, **change) -> TilePlan:
    """The tile plan a launch on `device` uses in the mode of `dtype`:
    tile_plan with the card's own wave of clusters (`change`: tile_plan's
    kc / stages)."""
    nt, mt, _ = warp_grid(C)
    wave = wave_clusters(torch.device(device).index or 0, len(dilation_sets), nt, mt, dtype)
    return tile_plan(C, dilation_sets, kernel_size, up_cin, up_k, up_stride, B, L_out, wave,
                     elem=dtype.itemsize, **change)


def _launch(x, blocks, dilation_sets, kernel_size, upsample, in_bias,
            in_leaky, out_leaky, packed: Optional[PackedStage],
            plan: Optional[TilePlan] = None) -> torch.Tensor:
    """Check the arguments and launch the kernel once (packing the weights
    first when the caller did not).  plan: a geometry other than
    stage_plan's, for measuring variants."""
    dtype = x.dtype
    _check_dtypes(dtype, blocks, upsample)
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
    w_shape = ((n_conv, kernel_size, C, C) if dtype == torch.float32
               else (n_conv, kernel_size, C // 2, C, 2))
    if tuple(packed.w.shape) != w_shape or tuple(packed.b.shape) != (n_conv, C):
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
        if Cin % (16 // dtype.itemsize):
            raise ValueError(f"mrf_stage kernel: the upsample's input channels ({Cin}) "
                             f"must be a multiple of {16 // dtype.itemsize}")
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
                          Cin if upsample is not None else 0, K_up, stride, dtype)
    ib = None if in_bias is None else _aligned(in_bias.to(dev, torch.float32).contiguous())
    if ib is not None and ib.shape != (C,):
        raise ValueError(f"in_bias has shape {tuple(ib.shape)}, want ({C},)")
    x = _aligned(x)
    w_up = _aligned(packed.w_up) if upsample is not None else None
    w, b = _aligned(packed.w), _aligned(packed.b)
    for t, want in ((w_up, dtype), (w, dtype), (b, torch.float32)):
        if t is not None and (t.device != dev or t.dtype != want or not t.is_contiguous()):
            raise TypeError(f"mrf_stage kernel: packed weights must be contiguous {dtype} "
                            f"(biases float32) on the input's device")

    n_dmax = max(len(d) for d in dilation_sets)
    dils = (ctypes.c_int * (len(blocks) * n_dmax))(
        *[ds[i] if i < len(ds) else 0 for ds in dilation_sets for i in range(n_dmax)])
    y = torch.empty(B, L_out, C, device=dev, dtype=dtype)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stage[dtype](
            x.data_ptr(), _ptr(w_up), _ptr(ib), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), B, L_in, Cin, C, L_out, K_up, stride, pad,
            int(in_leaky is not None), float(in_leaky or 0.0),
            int(out_leaky is not None), float(out_leaky or 0.0),
            len(blocks), n_dmax, kernel_size, dils,
            halo, plan.tile, plan.ss, plan.kc * dtype.itemsize // 4, plan.stages, plan.nt,
            plan.mt, plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"mrf_stage kernel launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")
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
    (float32 or bfloat16; the weights must have the same).
    """
    if x.device.type == "cpu":
        return mrf_stage_ref(x, blocks, dilation_sets, kernel_size,
                             upsample=upsample, in_bias=in_bias,
                             in_leaky=in_leaky, out_leaky=out_leaky)
    _check_options(upsample, in_leaky)
    refuse_autograd(x, blocks, upsample, in_bias)
    y = _launch(x, blocks, dilation_sets, kernel_size, upsample, in_bias,
                in_leaky, out_leaky, packed)
    _count_launch(mrf_stage)
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
    refuse_autograd(x, blocks)
    y = _launch(x, blocks, dilation_sets, kernel_size, None, None, None, None, packed)
    _count_launch(mrf_stage_unfolded)
    return y


mrf_stage_unfolded.launches = 0
