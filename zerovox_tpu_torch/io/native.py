"""ctypes binding to the native (C++) library: the port of zerovox_tpu/io/native.py.

Fast paths: mmap'd GGUF tensor reads, bulk f16/bf16 widening, and PCM16 WAV
output.  The source is the port's own copy, zerovox_tpu_torch/csrc/zvnative.cpp
(of native/zvnative.cpp), compiled at first use with native/Makefile's flags
into the port's build directory (utils.compile_cache.build_dir()), under a
name made from a digest of the source and the flags; a build found there is
reused.  Nothing is written to or loaded from native/.  Without a C++
compiler (g++, or $CXX) `available()` is False and every caller takes its
numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "zvnative.cpp"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-Wpedantic", "-Werror",
            "-shared")

_lock = threading.Lock()
_lib = None
_build_failed = False
build_seconds: Optional[float] = None   # the compile's wall time, 0 when a build was reused
build_error = ""                        # why the library is unavailable


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX") or "g++")


def _build(out: Path) -> bool:
    """Compile SOURCE into `out` (through a temporary file: a reader never
    sees a partial library); False, with build_error set, if it fails."""
    global build_error
    cxx = _compiler()
    if cxx is None:
        build_error = "no C++ compiler (g++ or $CXX) on PATH"
        return False
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        run = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True, timeout=120)
        if run.returncode != 0:
            build_error = f"{cxx} failed on {SOURCE}:\n{run.stderr}"
            return False
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        build_error = f"{cxx}: {e}"
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _build_failed, build_seconds, build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or not SOURCE.exists():
            return None
        from ..utils.compile_cache import build_dir, note_loaded
        digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()
                                ).hexdigest()[:12]
        out_dir = build_dir()
        path = out_dir / f"zvnative_{digest}.so"
        t0 = time.perf_counter()
        if not path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            if not _build(path):
                _build_failed = True
                return None
            build_seconds = time.perf_counter() - t0
        else:
            build_seconds = 0.0
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            build_error = str(e)
            _build_failed = True
            return None
        note_loaded(path)

        lib.zv_gguf_open.restype = ctypes.c_void_p
        lib.zv_gguf_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.zv_gguf_close.argtypes = [ctypes.c_void_p]
        lib.zv_gguf_n_tensors.restype = ctypes.c_int64
        lib.zv_gguf_n_tensors.argtypes = [ctypes.c_void_p]
        lib.zv_gguf_tensor_name.restype = ctypes.c_char_p
        lib.zv_gguf_tensor_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.zv_gguf_tensor_info.restype = ctypes.c_int
        lib.zv_gguf_tensor_info.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.zv_gguf_tensor_data.restype = ctypes.c_void_p
        lib.zv_gguf_tensor_data.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.zv_f16_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.zv_bf16_to_f32.argtypes = lib.zv_f16_to_f32.argtypes
        lib.zv_wav_write_pcm16.restype = ctypes.c_int
        lib.zv_wav_write_pcm16.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


class NativeGGUF:
    """Native mmap'd GGUF tensor accessor (metadata still read in Python)."""

    _GGML_TO_NP = {0: np.float32, 1: np.float16, 24: np.int8, 25: np.int16,
                   26: np.int32, 27: np.int64, 28: np.float64}

    def __init__(self, path: str):
        self._h = None
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        err = ctypes.create_string_buffer(256)
        self._h = lib.zv_gguf_open(os.fsencode(path), err, 256)
        if not self._h:
            raise ValueError(f"{path}: {err.value.decode()}")

    def tensor_names(self):
        n = self._lib.zv_gguf_n_tensors(self._h)
        return [self._lib.zv_gguf_tensor_name(self._h, i).decode() for i in range(n)]

    def get(self, name: str, as_float32: bool = False) -> np.ndarray:
        lib = self._lib
        gt, nd, nb = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
        ne = (ctypes.c_int64 * 4)()
        if lib.zv_gguf_tensor_info(self._h, name.encode(), ctypes.byref(gt), ctypes.byref(nd),
                                   ne, ctypes.byref(nb)) != 0:
            raise KeyError(name)
        ptr = lib.zv_gguf_tensor_data(self._h, name.encode())
        if not ptr:
            raise KeyError(name)
        shape = tuple(reversed([ne[d] for d in range(nd.value)]))      # numpy order
        nelem = int(np.prod(shape)) if shape else 1

        widen = {30: lib.zv_bf16_to_f32}                 # BF16 -> f32 always
        if as_float32:
            widen[1] = lib.zv_f16_to_f32                 # F16 -> f32 when asked
        if gt.value in widen:
            out = np.empty(nelem, dtype=np.float32)
            widen[gt.value](ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint16)),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nelem)
            return out.reshape(shape)
        if gt.value not in self._GGML_TO_NP:
            raise NotImplementedError(f"{name}: ggml type {gt.value}")
        dt = np.dtype(self._GGML_TO_NP[gt.value])
        buf = (ctypes.c_uint8 * int(nb.value)).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dt).reshape(shape)
        if as_float32 and arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        return arr

    def load_all(self, as_float32: bool = True) -> Dict[str, np.ndarray]:
        # copy=True detaches from the mmap so close() is safe afterwards
        return {n: np.array(self.get(n, as_float32=as_float32), copy=True)
                for n in self.tensor_names()}

    def close(self):
        if self._h:
            self._lib.zv_gguf_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_wav_native(path: str, wav: np.ndarray, sampling_rate: int) -> bool:
    """Native PCM16 WAV write; returns False if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    wav = np.ascontiguousarray(np.asarray(wav, dtype=np.float32).reshape(-1))
    rc = lib.zv_wav_write_pcm16(os.fsencode(path),
                                wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                wav.size, sampling_rate)
    if rc != 0:
        raise OSError(f"native WAV write failed ({rc}): {path}")
    return True
