"""Named-intermediate capture: the stages' probe points as a dict of tensors.

The port of zerovox_tpu/utils/debug.py.  The models call tap(name, x) at the
same probe points under the same names (encoder_output, pitch, energy,
features, log_duration, mel, dbg, wav).  A tap is one context-variable
lookup when no capture is active: it launches nothing and waits for nothing,
so the serving path pays nothing for it.  capture_run() runs a function with
a collection dict installed and returns the tapped tensors beside the output.

The collection dict lives in a `contextvars` variable, which every thread
has its own value of: a capture in one request handler never sees the taps
of another.  PyTorch runs eagerly, so there is no re-trace and no compiled
program to dump (the JAX module's dump_hlo / dump_dot have no counterpart).
"""

from __future__ import annotations

import contextvars
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

_capture_ctx: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "zerovox_tap_capture", default=None)


def tap(name: str, value):
    """Register an intermediate under `name` if a capture is active on this
    thread.  Returns `value` unchanged so it can be used inline."""
    ctx = _capture_ctx.get()
    if ctx is not None:
        ctx[name] = value
    return value


def capture_run(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Run fn with taps enabled; returns (output, {name: tensor}).  The
    tensors stay where they were computed."""
    token = _capture_ctx.set({})
    try:
        out = fn(*args, **kwargs)
        taps = dict(_capture_ctx.get())
    finally:
        _capture_ctx.reset(token)
    return out, taps


def summarize(name: str, x) -> str:
    """One-line summary of a tensor or array: shape, head and tail values, sum."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    a = np.asarray(x, dtype=np.float64).reshape(-1)
    head = ", ".join(f"{v:.5f}" for v in a[:3])
    tail = ", ".join(f"{v:.5f}" for v in a[-3:]) if a.size > 3 else ""
    return (f"{name} {list(np.shape(x))} = [{head} ... {tail}] "
            f"sum: {a.sum():.6f}")


def print_taps(taps: Dict[str, torch.Tensor]):
    for name, value in taps.items():
        print(summarize(name, value))
