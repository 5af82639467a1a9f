"""--compile-cache for the port (zerovox_tpu_torch.utils.compile_cache): the
port's compiled libraries are its builds from source, named by a digest of
the source and the flags, so the names do not depend on where the cache
directory lies (the property tests/test_compile_cache.py asks of the JAX
cache), a second process finds them built, and both CLIs take the flag.
Processes of their own: the cache directory is process-wide state.  The
kernel's nvcc build finding the cache is checked on the card (chip_smoke.py
phase 10 (c)); here the native library is the build."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from zerovox_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}

SCRIPT = r"""
import json, sys
from zerovox_tpu_torch.utils import enable_compile_cache
from zerovox_tpu_torch.io import native
path = enable_compile_cache(sys.argv[1])
ok = native.available()
print(json.dumps({"path": path, "ok": ok, "build_seconds": native.build_seconds}))
"""


def _run(cache_dir):
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(cache_dir)], capture_output=True,
                       text=True, timeout=240, env=ENV)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_cache_keys_independent_of_cache_dir_location(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++: nothing is built here")
    here, there = tmp_path / "cache-here", tmp_path / "deeply" / "nested" / "elsewhere"
    a = _run(here)
    assert a["ok"] and a["path"] == str(here) and a["build_seconds"] > 0
    b = _run(there)
    assert b["ok"] and b["build_seconds"] > 0
    names = sorted(p.name for p in here.iterdir())
    assert names == sorted(p.name for p in there.iterdir()) and names
    assert _run(here)["build_seconds"] == 0.0       # a second process finds the build


def test_enable_after_a_library_is_loaded_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "_loaded", ["zvnative_x.so"])
    with pytest.raises(RuntimeError, match="must be called before the programs are compiled"):
        compile_cache.enable_compile_cache(str(tmp_path / "c"))
    monkeypatch.setattr(compile_cache, "_loaded", [])
    monkeypatch.setattr(compile_cache, "_dir", None)
    assert compile_cache.enable_compile_cache(str(tmp_path / "c")) == str(tmp_path / "c")
    assert compile_cache.build_dir() == tmp_path / "c" and (tmp_path / "c").is_dir()


def test_clis_take_the_flag(tmp_path):
    """The serving CLI (one-shot, on the CPU) and the training CLI accept
    --compile-cache DIR and say where it is; the serving CLI's WAV goes
    through the native writer built in DIR."""
    cache = tmp_path / "cc"
    model = tmp_path / "m.gguf"
    out = subprocess.run(
        [sys.executable, "-m", "zerovox_tpu_torch.training.cli", "--synthetic", "2", "--tiny",
         "--batch-size", "2", "--no-stft", "--device", "cpu", "--compile-cache", str(cache),
         "--export", str(model)], capture_output=True, text=True, timeout=240, env=ENV)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"train: compile cache {cache}" in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "zerovox_tpu_torch.cli", "--model", str(model), "--demo",
         "--device", "cpu", "--compile-cache", str(cache), "--output", str(tmp_path / "o.wav")],
        capture_output=True, text=True, timeout=240, env=ENV)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"compile cache: {cache}" in out.stderr
    assert (tmp_path / "o.wav").stat().st_size > 44
    if shutil.which("g++"):
        assert [p.name.startswith("zvnative_") for p in cache.glob("*.so")] == [True]
