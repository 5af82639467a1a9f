"""Where the port keeps its compiled libraries, and --compile-cache DIR.

The port of zerovox_tpu/utils/compile_cache.py.  The JAX package's compiled
programs are XLA executables; the port's are its two builds from source:
the MRF kernel's shared libraries (nvcc, one per mode,
ops/cuda/mrf_stage.py) and the native GGUF/WAV library (g++, io/native.py).
Each build is named by a digest of its source and its flags and is reused
wherever a file of that name exists, so a process that finds them built
compiles nothing (the kernel's nvcc takes 16-30 s per process on the card's
machine).

By default they go to build/zerovox_tpu_torch/ at the root of the checkout.
`enable_compile_cache(DIR)` moves that directory to DIR for this process
(--compile-cache DIR on both CLIs): processes that share DIR share the
builds, and a package installed where build/ is not writable can still
cache them.  The names depend on the sources and flags alone, never on DIR's
location, so a cache directory can be moved or copied.

It must be called before the libraries are loaded: afterwards it raises,
since a process keeps the libraries it has loaded.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import List, Optional

DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zerovox_tpu_torch"

_lock = threading.Lock()
_dir: Optional[Path] = None
_loaded: List[str] = []          # the libraries this process has loaded


def build_dir() -> Path:
    """The directory the port's builds go to and are looked for in."""
    return DEFAULT_BUILD_DIR if _dir is None else _dir


def note_loaded(path) -> None:
    """Record a library loaded from build_dir() (mrf_stage and native call it)."""
    with _lock:
        _loaded.append(str(path))


def loaded() -> List[str]:
    """The libraries this process has loaded from its build directory."""
    with _lock:
        return list(_loaded)


def enable_compile_cache(path: str) -> str:
    """Keep the port's compiled libraries under `path` (created if missing);
    returns its absolute path.  Must be called before the programs are
    compiled: once a library is loaded it raises RuntimeError."""
    global _dir
    path = os.path.abspath(os.path.expanduser(path))
    with _lock:
        if _loaded:
            raise RuntimeError(
                "enable_compile_cache must be called before the programs are compiled: "
                f"this process already loaded {_loaded} from {build_dir()}")
        os.makedirs(path, exist_ok=True)
        _dir = Path(path)
    return path
