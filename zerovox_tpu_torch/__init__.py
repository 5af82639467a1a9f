"""zerovox_tpu_torch — the PyTorch/CUDA port of zerovox_tpu.

FastSpeech2 encoder + variance adaptor, StyleTTS mel decoder and HiFi-GAN
vocoder on PyTorch, with the vocoder's fused multi-receptive-field stage as
a hand-written CUDA kernel for Hopper (sm_90a).  Same GGUF checkpoints and
parameter paths as the JAX package, which it imports nothing of.

Entry points run on the card (device="cuda") unless the caller passes
device="cpu".
"""

__version__ = "0.1.0"

from .config import TINY_CONFIG, ZeroVoxConfig
from .models.pipeline import SynthesisResult, synthesize
from .params import init_params, load_params, save_params
from .runtime.engine import TTSEngine

__all__ = [
    "ZeroVoxConfig", "TINY_CONFIG",
    "init_params", "load_params", "save_params",
    "synthesize", "SynthesisResult", "TTSEngine",
]
