"""zerovox_tpu_torch — the PyTorch/CUDA port of zerovox_tpu.

FastSpeech2 encoder + variance adaptor, StyleTTS mel decoder and HiFi-GAN
vocoder on PyTorch, with the vocoder's fused multi-receptive-field stage as
a hand-written CUDA kernel for Hopper (sm_90a).  Same GGUF checkpoints and
parameter paths as the JAX package, which it imports nothing of.

float32 is the parity dtype, bfloat16 (TTSEngine(precision="bfloat16"),
cfg.compute_dtype) the serving dtype; StreamingSynthesizer vocodes in
chunks for a short time to first audio.  TTSServer is the HTTP serving
daemon (the CLI's --serve) over one engine and one synthesizer, with
DynamicBatcher coalescing concurrent requests; TTSClient talks to it, in
the JAX package's wire format.  zerovox_tpu_torch.training trains on one
card (losses, AdamW, fit, checkpoints, GGUF export, its CLI).
zerovox_tpu_torch.parallel serves over several devices from one process:
data and tensor parallelism (make_mesh, make_sharded_synthesize), the
time-parallel vocoder and the two-stage pipeline; TTSEngine(mesh=),
runtime.tp_engine.TPServingEngine and TTSServer(mesh=) build on it.

Entry points run on the card (device="cuda") unless the caller passes
device="cpu".
"""

__version__ = "0.1.0"

from .config import TINY_CONFIG, ZeroVoxConfig
from .models.pipeline import SynthesisResult, cast_params, synthesize
from .models.streaming import StreamingSynthesizer
from .params import init_params, load_params, save_params
from .runtime.batcher import DynamicBatcher
from .runtime.client import TTSClient
from .runtime.engine import TTSEngine
from .runtime.longform import synthesize_long
from .runtime.server import TTSServer

__all__ = [
    "ZeroVoxConfig", "TINY_CONFIG",
    "init_params", "load_params", "save_params",
    "synthesize", "SynthesisResult", "cast_params", "TTSEngine",
    "StreamingSynthesizer", "synthesize_long",
    "TTSServer", "DynamicBatcher", "TTSClient",
]
