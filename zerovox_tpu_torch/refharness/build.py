"""Build-and-load machinery for the ggml reference harness.

The port's copy of zerovox_tpu/refharness/build.py.  It builds the
reference's VENDORED ggml runtime (<reference>/ggml, CPU backend only) once,
compiles harness.c (op-level entries) and stage_harness.cpp (the reference's
own FS2Encoder / StyleTTSDecoder / HiFiGAN classes, compiled unmodified)
against it, and loads the result with ctypes.  Everything is best-effort:
callers get (None, reason) when the toolchain or the reference tree is
unavailable, with the JAX package's reasons ("reference ggml tree not
available", "cmake/ninja not available", ...); `cli --verify` then exits 2.

The reference tree's root is $ZEROVOX_REF, read at each call, else
reference/ at the root of the checkout.  It is read-only and ships without
ggml.pc.in / tests / examples; a symlink shadow tree supplies the stubs.

The builds go under one build directory: the `build` argument, else
$ZEROVOX_REFHARNESS_BUILD, else build/zerovox_tpu_torch/refharness/ at the
root of the checkout (utils.compile_cache's default build directory).  The
package's callers pass utils.compile_cache.build_dir() / "refharness", so
--compile-cache moves it too, and hand it to the stage worker in
$ZEROVOX_REFHARNESS_BUILD.

This module imports the standard library only: the stage worker
(stage_proc.py) loads it by file path, so that its process imports neither
this package (which imports torch) nor anything else beyond numpy.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

REF_ENV = "ZEROVOX_REF"
BUILD_ENV = "ZEROVOX_REFHARNESS_BUILD"
_HERE = Path(__file__).resolve().parent
_CHECKOUT = _HERE.parents[1]
DEFAULT_REF = _CHECKOUT / "reference"
DEFAULT_BUILD = _CHECKOUT / "build" / "zerovox_tpu_torch" / "refharness"
HARNESS_C = _HERE / "harness.c"
STAGE_CPP = _HERE / "stage_harness.cpp"
ZEROMALLOC_C = _HERE / "zeromalloc.c"
# the reference's own stage classes, compiled unmodified as the diff subject
STAGE_REF_SOURCES = ("fs2encoder.cpp", "stylettsdec.cpp", "hifigan.cpp",
                     "utils.cpp")

Result = Tuple[Optional[ctypes.CDLL], str]
_cached: Dict[tuple, Result] = {}
_stage_cached: Dict[tuple, Result] = {}


def ref_root() -> Path:
    """The reference tree: $ZEROVOX_REF, else reference/ in the checkout."""
    return Path(os.environ.get(REF_ENV) or DEFAULT_REF)


def build_root(build=None) -> Path:
    """The build directory: `build`, else $ZEROVOX_REFHARNESS_BUILD, else
    DEFAULT_BUILD."""
    return Path(build or os.environ.get(BUILD_ENV) or DEFAULT_BUILD)


class _Layout(NamedTuple):
    ref_ggml: Path
    ref_src: Path
    src_shadow: Path
    ggml_build: Path
    harness_so: Path
    stage_so: Path
    zeromalloc_so: Path


def _layout(build=None) -> _Layout:
    ref, out = ref_root(), build_root(build)
    return _Layout(ref / "ggml", ref / "src", out / "ggml-src", out / "ggml-build",
                   out / "zv_ggml_harness.so", out / "zv_ggml_stages.so",
                   out / "zv_zeromalloc.so")


def _run(cmd, timeout=600):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)


def _shadow_tree(lay: _Layout):
    if not (lay.src_shadow / "CMakeLists.txt").exists():
        lay.src_shadow.parent.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(lay.src_shadow, ignore_errors=True)
        # symlink farm: sources stay in the read-only reference tree
        subprocess.run(["cp", "-rs", str(lay.ref_ggml), str(lay.src_shadow)],
                       check=True)
    pc = lay.src_shadow / "ggml.pc.in"
    if not pc.exists():
        pc.write_text("prefix=@CMAKE_INSTALL_PREFIX@\nName: ggml\n"
                      "Description: ggml\nVersion: @GGML_INSTALL_VERSION@\n")
    for d in ("tests", "examples"):
        (lay.src_shadow / d).mkdir(exist_ok=True)


def _build_ggml(lay: _Layout) -> Optional[str]:
    """Returns None on success, else the failure reason."""
    libs = [lay.ggml_build / "src" / n
            for n in ("libggml-base.so", "libggml-cpu.so")]
    if all(p.exists() for p in libs):
        return None
    if not lay.ref_ggml.exists():
        return "reference ggml tree not available"
    if not shutil.which("cmake") or not shutil.which("ninja"):
        return "cmake/ninja not available"
    try:
        _shadow_tree(lay)
        r = _run(["cmake", "-S", str(lay.src_shadow), "-B", str(lay.ggml_build),
                  "-G", "Ninja", "-DBUILD_SHARED_LIBS=ON", "-DGGML_CPU=ON",
                  "-DGGML_BUILD_TESTS=OFF", "-DGGML_BUILD_EXAMPLES=OFF",
                  "-DCMAKE_BUILD_TYPE=Release"])
        if r.returncode:
            return f"cmake configure failed: {r.stderr[-400:]}"
        r = _run(["ninja", "-C", str(lay.ggml_build)])
        if r.returncode:
            return f"ninja failed: {r.stderr[-400:]}"
    except (subprocess.TimeoutExpired, OSError) as e:
        return f"ggml build error: {e}"
    if not all(p.exists() for p in libs):
        return "ggml build produced no libraries"
    return None


def _build_harness(lay: _Layout) -> Optional[str]:
    if (lay.harness_so.exists()
            and lay.harness_so.stat().st_mtime >= HARNESS_C.stat().st_mtime):
        return None
    cc = shutil.which("cc") or shutil.which("gcc")
    if not cc:
        return "no C compiler"
    libdir = lay.ggml_build / "src"
    r = _run([cc, "-shared", "-fPIC", "-O2",
              "-I", str(lay.ref_ggml / "include"), str(HARNESS_C),
              "-o", str(lay.harness_so), "-L", str(libdir),
              "-lggml-cpu", "-lggml-base", f"-Wl,-rpath,{libdir}"])
    if r.returncode:
        return f"harness compile failed: {r.stderr[-400:]}"
    return None


def _declare(lib: ctypes.CDLL):
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    c_int, c_float = ctypes.c_int, ctypes.c_float
    lib.zv_ggml_norm.argtypes = [f32p, i64, i64, c_float, f32p]
    lib.zv_ggml_norm.restype = c_int
    lib.zv_ggml_soft_max.argtypes = [f32p, i64, i64, f32p]
    lib.zv_ggml_soft_max.restype = c_int
    lib.zv_ggml_mul_mat.argtypes = [f32p, i64, i64, c_int, f32p, i64, f32p]
    lib.zv_ggml_mul_mat.restype = c_int
    lib.zv_ggml_conv_1d.argtypes = [f32p, i64, i64, i64, c_int, f32p, i64,
                                    c_int, c_int, c_int, f32p]
    lib.zv_ggml_conv_1d.restype = c_int
    lib.zv_ggml_conv_transpose_1d_ref.argtypes = [
        f32p, i64, i64, i64, c_int, f32p, i64, c_int, c_int, c_int, f32p]
    lib.zv_ggml_conv_transpose_1d_ref.restype = c_int
    lib.zv_ggml_conv_out_len.argtypes = [i64, i64, c_int, c_int, c_int]
    lib.zv_ggml_conv_out_len.restype = i64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.zv_ggml_quantize.argtypes = [c_int, f32p, u8p, i64, i64]
    lib.zv_ggml_quantize.restype = i64
    lib.zv_ggml_quantize_row.argtypes = [c_int, f32p, u8p, i64]
    lib.zv_ggml_quantize_row.restype = c_int
    lib.zv_ggml_dequantize.argtypes = [c_int, u8p, f32p, i64]
    lib.zv_ggml_dequantize.restype = c_int


def _build_stage_harness(lay: _Layout) -> Optional[str]:
    ref_srcs = [lay.ref_src / n for n in STAGE_REF_SOURCES]
    if not all(p.exists() for p in ref_srcs):
        return "reference src tree not available"
    newest_dep = max(p.stat().st_mtime for p in ref_srcs + [STAGE_CPP])
    if lay.stage_so.exists() and lay.stage_so.stat().st_mtime >= newest_dep:
        return None
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return "no C++ compiler"
    libdir = lay.ggml_build / "src"
    r = _run([cxx, "-std=c++17", "-shared", "-fPIC", "-O2",
              "-I", str(lay.ref_ggml / "include"), "-I", str(lay.ref_src),
              str(STAGE_CPP), *[str(p) for p in ref_srcs],
              "-o", str(lay.stage_so), "-L", str(libdir),
              "-lggml-cpu", "-lggml-base", f"-Wl,-rpath,{libdir}"])
    if r.returncode:
        return f"stage harness compile failed: {r.stderr[-600:]}"
    return None


def get_zeromalloc(build=None) -> Optional[str]:
    """Build (once) and return the LD_PRELOAD zeroing-allocator path for
    the stage worker, or None when it cannot be built (the worker then
    runs without it: the differential tests may flake on the reference's
    uninitialized-memory reads; see zeromalloc.c)."""
    so = _layout(build).zeromalloc_so
    if so.exists() and so.stat().st_mtime >= ZEROMALLOC_C.stat().st_mtime:
        return str(so)
    cc = shutil.which("cc") or shutil.which("gcc")
    if not cc:
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    r = _run([cc, "-shared", "-fPIC", "-O2", str(ZEROMALLOC_C), "-o", str(so)])
    return str(so) if r.returncode == 0 else None


def _declare_stages(lib: ctypes.CDLL):
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    c_int, c_u32 = ctypes.c_int, ctypes.c_uint32
    lib.zv_stages_load.argtypes = [ctypes.c_char_p, u32p, i32p, c_int,
                                   i64p, c_int, c_int]
    lib.zv_stages_load.restype = c_int
    lib.zv_stages_encoder.argtypes = [i32p, i32p, f32p, c_u32, f32p]
    lib.zv_stages_encoder.restype = c_u32
    lib.zv_stages_decoder.argtypes = [f32p, f32p, f32p]
    lib.zv_stages_decoder.restype = c_int
    lib.zv_stages_hifigan.argtypes = [f32p, f32p]
    lib.zv_stages_hifigan.restype = c_int
    lib.zv_stages_free.argtypes = []
    lib.zv_stages_free.restype = None


def _load(cache: Dict[tuple, Result], build, build_lib, so_of, declare) -> Result:
    lay = _layout(build)
    key = (str(lay.ref_ggml), str(lay.ggml_build))
    if key not in cache:
        reason = _build_ggml(lay) or build_lib(lay)
        if reason:
            cache[key] = (None, reason)
        else:
            try:
                lib = ctypes.CDLL(str(so_of(lay)))
                declare(lib)
                cache[key] = (lib, "")
            except OSError as e:
                cache[key] = (None, f"dlopen failed: {e}")
    return cache[key]


def get_stage_harness(build=None) -> Result:
    """Reference-stage-class harness: (lib, "") or (None, reason).  Cached
    per process, reference tree and build directory."""
    return _load(_stage_cached, build, _build_stage_harness, lambda lay: lay.stage_so,
                 _declare_stages)


def get_harness(build=None) -> Result:
    """Op-level harness (harness.c): (lib, "") or (None, reason).  Cached
    per process, reference tree and build directory."""
    return _load(_cached, build, _build_harness, lambda lay: lay.harness_so, _declare)
