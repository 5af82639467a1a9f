"""Device resolution shared by the port's entry points.

Every entry point defaults to ``device="cuda"``.  Asking for CUDA where
PyTorch has no card raises here, with a message that names the way out
(``device="cpu"``); nothing silently carries on on the CPU.

Resolving a CUDA device also sets, once and for the process, the switch
that keeps cuBLAS's bfloat16 products accumulating in float32
(full_precision_products): the port's bf16 rule is bf16 operands, f32
accumulation, one rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def full_precision_products():
    """cuBLAS may split a bf16 product's reduction and sum the parts in
    bf16 (PyTorch's default); switch that off, so that every bf16 matmul of
    the port accumulates in f32 to the end.  A process-wide flag, set where
    a CUDA device is resolved and not around each product."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device) -> torch.device:
    """torch.device for `device`, raising if it names CUDA and none is usable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the CPU")
        full_precision_products()
    return dev


def to_host_async(t: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start copying a device tensor to the host without waiting for it:
    (pinned host tensor, event recorded behind the copy on the current
    stream).  The host tensor is whole once the event has been
    synchronised.  A CPU tensor comes back as it is, with no event."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def wait_host(pending: Tuple[torch.Tensor, Optional[torch.cuda.Event]]) -> torch.Tensor:
    """The host tensor of a to_host_async() pair, once its copy has landed."""
    host, event = pending
    if event is not None:
        event.synchronize()
    return host
