"""Device resolution shared by the port's entry points.

Every entry point defaults to ``device="cuda"``.  Asking for CUDA where
PyTorch has no card raises here, with a message that names the way out
(``device="cpu"``); nothing silently carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`, raising if it names CUDA and none is usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
