"""Device resolution shared by the port's entry points.

Every entry point defaults to ``device="cuda"``.  Asking for CUDA where
PyTorch has no card raises here, with a message that names the way out
(``device="cpu"``); nothing silently carries on on the CPU.

Resolving a CUDA device also sets, once and for the process, the switches
that keep the port's products at their full precision
(full_precision_products): no TF32 in float32 convolutions and matmuls
(float32 is the parity path), and cuBLAS's bfloat16 products accumulating in
float32 (the port's bf16 rule is bf16 operands, f32 accumulation, one
rounding).  They are process-wide flags, so they are set once and never
toggled around a product: a serving daemon runs products on many threads.

on_issuing_thread(device, fn, ...) runs a function on the issuing thread of
`device`: the serving paths make every run of launches (a front, a vocoder
call) there, whatever thread the request came in on.  Each device has one
such thread, so that the launches of one device of a mesh never wait behind
another's; a mesh that names one device several times has one thread for it.
"""

from __future__ import annotations

import contextvars
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import torch

from .utils import profiling

_issuers: Dict[torch.device, ThreadPoolExecutor] = {}
_issuer_guard = threading.Lock()
_issuer_thread = threading.local()


def issuing_key(device) -> torch.device:
    """The device whose issuing thread `device` uses: "cuda" and "cuda:0"
    (when 0 is the current card) are one device and share one thread."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def submit_on_issuing_thread(device, fn: Callable, *args, span: Optional[str] = None,
                             **kwargs) -> Future:
    """fn(*args, **kwargs) on the issuing thread of `device`, without waiting:
    a Future of its result.  Called from that thread, fn runs inline (the
    Future is done when this returns).  A caller reads the result of every
    Future it gets: the exception of fn is raised there.

    span: the name under which the span recorder (utils.profiling) records
    fn's run on the issuing thread ("issue.front", "issue.vocode",
    "issue.stream"), after an "issue.wait" span on the calling thread from
    now until fn starts; None records nothing."""
    if span is not None:
        fn = profiling.issued(span, fn)
    key = issuing_key(device)
    if getattr(_issuer_thread, "device", None) == key:
        done: Future = Future()
        try:
            done.set_result(fn(*args, **kwargs))
        except BaseException as e:       # noqa: BLE001  (handed to the caller)
            done.set_exception(e)
        return done
    with _issuer_guard:
        pool = _issuers.get(key)
        if pool is None:
            pool = _issuers[key] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"zv-launch-{key}",
                initializer=lambda: setattr(_issuer_thread, "device", key))
    # in the caller's context: a debug capture (utils.debug) sees the taps made
    # there, and the spans recorded there name the caller's request and span
    return pool.submit(contextvars.copy_context().run, fn, *args, **kwargs)


def on_issuing_thread(device, fn: Callable, *args, span: Optional[str] = None, **kwargs):
    """fn(*args, **kwargs) on the issuing thread of `device`; returns its
    result or raises its exception.  Called from that thread, fn runs inline.
    span: as submit_on_issuing_thread's.

    The serving engine and the streaming synthesizer issue their launches
    through here and wait for the device on their own threads, so that one
    request's device work overlaps the next one's launches.  Two facts of
    PyTorch on a card make one long-lived thread per device the place to
    issue from (measured on an H100, PERF.md):

    * cuDNN's execution plans are cached by the thread that ran the
      convolution.  A thread's first front builds a plan for every
      convolution geometry of the model, 60-180 ms against 10-20 ms for a
      warm front, so a server that starts a thread per connection, or has a
      pool of handler threads, pays that again and again.
    * A front is several hundred small calls, each of which gives up the
      interpreter lock and takes it again.  Threads that issue at the same
      time hand the interpreter back and forth at every call: 8 threads
      issuing B=1 fronts freely took 2.5-3 times the wall of the same
      fronts issued one at a time.  The threads of several devices contend
      in the same way; that cost is measured only where a machine has more
      than one card.

    A device's thread is started by the first call for it and lives as long
    as the process; PyTorch's thread-local switches (inference mode, the
    current device) are fn's to set."""
    return submit_on_issuing_thread(device, fn, *args, span=span, **kwargs).result()


def full_precision_products():
    """Process-wide flags, set where a CUDA device is resolved and not
    around each product (a save/restore per product races between threads).

    PyTorch lets cuDNN use TF32 for float32 convolutions by default, which
    keeps about three decimal digits: off, for convolutions and matmuls.
    cuBLAS may split a bf16 product's reduction and sum the parts in bf16:
    off, so that every bf16 matmul of the port accumulates in f32 to the end."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device) -> torch.device:
    """torch.device for `device`, raising if it names CUDA and none is usable.
    A CUDA device comes back with its index ("cuda" is the current card), so
    that two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the CPU")
        full_precision_products()
        dev = issuing_key(dev)
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
    event.record(torch.cuda.current_stream(t.device))   # the copy runs on t's card's stream
    return host, event


def wait_host(pending: Tuple[torch.Tensor, Optional[torch.cuda.Event]]) -> torch.Tensor:
    """The host tensor of a to_host_async() pair, once its copy has landed."""
    host, event = pending
    if event is not None:
        event.synchronize()
    return host
