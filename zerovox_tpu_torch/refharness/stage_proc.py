"""Process-isolated facade over the reference's C++ stage classes.

The port's copy of zerovox_tpu/refharness/stage_proc.py, with the same wire
protocol.  The reference model classes assume a FRESH PROCESS: their
hand-rolled ConvTranspose1d never zeroes the gaps of its zero-stuffed
intermediate (the reference's src/hifigan.cpp:50-55 writes only the strided
view rows), so correctness rests on allocator pages being zero-born; their
graph metadata lives in function-local static buffers (fs2encoder.cpp:514-515),
so only one model per process.  A long-lived process that shares its heap
with torch breaks those assumptions nondeterministically.

The facade therefore hosts the classes in a dedicated worker subprocess
(this file run as a script) speaking length-prefixed pickles over
stdin/stdout; the parent-side RefStages keeps the interface of the
in-process classes.  The worker imports only the standard library and numpy
(neither torch nor jax), loads build.py by file path, finds the build
directory in $ZEROVOX_REFHARNESS_BUILD, and runs with the zeroing allocator
(zeromalloc.c) preloaded.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import struct
import subprocess
import sys

import numpy as np

F32P = ctypes.POINTER(ctypes.c_float)
I32P = ctypes.POINTER(ctypes.c_int32)


def _geom_from_cfg(cfg) -> dict:
    return dict(
        geom=[cfg.max_n_phonemes, cfg.emb_dim, cfg.punct_emb_dim,
              cfg.encoder_layer, cfg.encoder_head, cfg.conv_filter_size,
              cfg.conv_kernel_size[0], cfg.conv_kernel_size[1],
              cfg.vp_kernel_size, cfg.ve_n_bins, cfg.max_seq_len,
              cfg.num_mels, cfg.hop_size, cfg.residual_dim,
              cfg.hifigan_kernel_size],
        scales=list(cfg.upsample_scales),
        dils=[d for blk in cfg.resblock_dilations for d in blk],
        num_resblocks=cfg.num_resblocks,
        num_dils=len(cfg.resblock_dilations[0]),
        d_model=cfg.d_model,
        max_seq_len=cfg.max_seq_len,
        num_mels=cfg.num_mels,
        hop_size=cfg.hop_size,
        max_n_phonemes=cfg.max_n_phonemes,
    )


# --------------------------------------------------------------- in-process
class InprocStages:
    """ctypes facade over the loaded reference stage classes (worker side)."""

    def __init__(self, lib, gguf_path: str, g: dict):
        self.lib = lib
        self.g = g
        geom = np.array(g["geom"], dtype=np.uint32)
        scales = np.array(g["scales"], dtype=np.int32)
        dils = np.array(g["dils"], dtype=np.int64)
        rc = lib.zv_stages_load(
            gguf_path.encode(),
            geom.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            scales.ctypes.data_as(I32P), len(scales),
            dils.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            g["num_resblocks"], g["num_dils"])
        if rc != 0:
            raise RuntimeError("reference model load failed (see stderr)")

    def encoder(self, src, puncts, style, num_phonemes):
        g = self.g
        x = np.zeros(g["max_seq_len"] * g["d_model"], dtype=np.float32)
        src = np.ascontiguousarray(src, dtype=np.int32)
        puncts = np.ascontiguousarray(puncts, dtype=np.int32)
        style = np.ascontiguousarray(style, dtype=np.float32)
        mel_len = self.lib.zv_stages_encoder(
            src.ctypes.data_as(I32P), puncts.ctypes.data_as(I32P),
            style.ctypes.data_as(F32P), num_phonemes,
            x.ctypes.data_as(F32P))
        if mel_len == np.iinfo(np.uint32).max:
            raise RuntimeError("reference encoder failed (see stderr)")
        return x.reshape(g["max_seq_len"], g["d_model"]), int(mel_len)

    def decoder(self, hidden, style):
        g = self.g
        mel = np.zeros(g["max_seq_len"] * g["num_mels"], dtype=np.float32)
        hidden = np.ascontiguousarray(hidden, dtype=np.float32)
        style = np.ascontiguousarray(style, dtype=np.float32)
        rc = self.lib.zv_stages_decoder(hidden.ctypes.data_as(F32P),
                                        style.ctypes.data_as(F32P),
                                        mel.ctypes.data_as(F32P))
        if rc != 0:
            raise RuntimeError("reference decoder failed (see stderr)")
        return mel.reshape(g["max_seq_len"], g["num_mels"])

    def vocoder(self, mel):
        g = self.g
        wav = np.zeros(g["max_seq_len"] * g["hop_size"], dtype=np.float32)
        mel = np.ascontiguousarray(mel, dtype=np.float32)
        rc = self.lib.zv_stages_hifigan(mel.ctypes.data_as(F32P),
                                        wav.ctypes.data_as(F32P))
        if rc != 0:
            raise RuntimeError("reference vocoder failed (see stderr)")
        return wav

    def free(self):
        self.lib.zv_stages_free()


# ------------------------------------------------------------ wire protocol
def _send(f, obj):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(struct.pack("<Q", len(data)))
    f.write(data)
    f.flush()


def _recv(f):
    hdr = f.read(8)
    if len(hdr) < 8:
        raise EOFError("stage worker pipe closed")
    (n,) = struct.unpack("<Q", hdr)
    return pickle.loads(f.read(n))


def _worker_main():
    # load build.py by file path: importing it through the zerovox_tpu_torch
    # package would execute the package __init__ (torch and friends), and
    # this worker's whole purpose is a pristine heap (module docstring)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_zv_refharness_build",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fin = sys.stdin.buffer
    # the reference printf's its dbg tensor to C-level stdout on every
    # HiFiGAN eval (its src/hifigan.cpp:365-372): that must not corrupt the
    # pickle stream, so keep the protocol on a dup of the original fd and
    # point fd 1 (and python-level stdout) at stderr
    proto_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    fout = os.fdopen(proto_fd, "wb")

    lib, reason = mod.get_stage_harness()       # the build directory: $ZEROVOX_REFHARNESS_BUILD
    _send(fout, ("ok", None) if lib is not None else ("err", reason))
    inst = None
    while True:
        try:
            op, args = _recv(fin)
        except EOFError:
            return
        try:
            if op == "load":
                inst = InprocStages(lib, args[0], args[1])
                res = None
            elif op == "free":
                inst.free()
                inst = None
                res = None
            elif op == "exit":
                return
            else:
                res = getattr(inst, op)(*args)
            _send(fout, ("ok", res))
        except Exception as e:                       # noqa: BLE001  (sent to the parent)
            _send(fout, ("err", f"{type(e).__name__}: {e}"))


# ------------------------------------------------------------- parent side
def worker_env(build=None) -> dict:
    """The worker's environment: the checkout on PYTHONPATH, the build
    directory (build.build_root(build)) in $ZEROVOX_REFHARNESS_BUILD, and
    the zeroing allocator in LD_PRELOAD where it builds."""
    from . import build as build_mod
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), env.get("PYTHONPATH", "")) if p)
    env[build_mod.BUILD_ENV] = str(build_mod.build_root(build))
    # Zero-born allocations for the WHOLE worker: the reference classes read
    # uninitialized allocator memory (ConvTranspose gaps, ggml's per-compute
    # work buffer) and are only correct when every allocation arrives
    # zeroed: true for fresh mmap pages, false for free-list reuse, which no
    # mallopt can prevent.  The LD_PRELOAD shim (zeromalloc.c) makes it true
    # unconditionally; without it the observed failures were a constant
    # bias-only wav, a NaN tail and all samples off, nondeterministic with
    # the heap's layout.
    zm = build_mod.get_zeromalloc(build)
    if zm:
        env["LD_PRELOAD"] = os.pathsep.join(
            p for p in (zm, env.get("LD_PRELOAD", "")) if p)
    return env


def start_worker(build=None) -> subprocess.Popen:
    """The worker process (this file as a script) on pipes, in worker_env."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            env=worker_env(build))


class RefStages:
    """Subprocess-backed facade with the interface of InprocStages.

    `lib` (the parent's handle from get_stage_harness, used only for the
    skip decision) is accepted and ignored: the worker loads its own copy
    in its own pristine process.  build: the build directory (default
    utils.compile_cache.build_dir() / "refharness").  A worker that fails or
    dies raises RuntimeError (or EOFError on a closed pipe) in the caller.
    """

    def __init__(self, lib, gguf_path: str, cfg, build=None):
        del lib
        if build is None:
            from ..utils.compile_cache import build_dir
            build = build_dir() / "refharness"
        self._proc = start_worker(build)
        try:
            status, reason = _recv(self._proc.stdout)
            if status != "ok":
                raise RuntimeError(
                    f"stage worker failed to build/load: {reason}")
            self._call("load", (gguf_path, _geom_from_cfg(cfg)))
        except BaseException:
            # don't leak a worker blocked in its stdin loop when init fails
            self._proc.kill()
            self._proc.wait(timeout=10)
            raise

    def _call(self, op, args=()):
        _send(self._proc.stdin, (op, args))
        status, res = _recv(self._proc.stdout)
        if status != "ok":
            raise RuntimeError(f"stage worker {op} failed: {res}")
        return res

    def encoder(self, src, puncts, style, num_phonemes):
        return self._call("encoder", (np.asarray(src), np.asarray(puncts),
                                      np.asarray(style), int(num_phonemes)))

    def decoder(self, hidden, style):
        return self._call("decoder", (np.asarray(hidden), np.asarray(style)))

    def vocoder(self, mel):
        return self._call("vocoder", (np.asarray(mel),))

    def free(self):
        try:
            self._call("free")
            _send(self._proc.stdin, ("exit", ()))
        except (RuntimeError, BrokenPipeError, EOFError):
            pass
        self._proc.stdin.close()
        self._proc.wait(timeout=30)


if __name__ == "__main__":
    _worker_main()
