"""Model / audio / runtime configuration (the port's copy of zerovox_tpu/config.py).

The same typed, serialisable config object as the JAX package, field for
field, so a GGUF written by either package round-trips exactly through the
other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ZeroVoxConfig:
    """Complete hyper-parameter set for the three-stage TTS pipeline."""

    # ---- text front-end (reference: src/zerovox.h:35-37) ----
    num_phonemes: int = 154          # vocabulary size (emb table has num_phonemes+1 rows)
    num_puncts: int = 6              # punctuation vocab (emb table has num_puncts+1 rows)
    max_n_phonemes: int = 120        # static phoneme-sequence length (padded)

    # ---- embedding geometry (GGUF KV: emb_dim / punct_emb_dim) ----
    emb_dim: int = 512
    punct_emb_dim: int = 16

    # ---- FastSpeech2 encoder (GGUF KV: encoder.*) ----
    encoder_layer: int = 4
    encoder_head: int = 2
    conv_filter_size: int = 1024                 # FFN hidden dim (decoder.conv_filter_size key)
    conv_kernel_size: Tuple[int, int] = (9, 1)   # FFN conv kernel sizes
    vp_filter_size: int = 256                    # variance-predictor hidden dim
    vp_kernel_size: int = 3
    ve_n_bins: int = 256                         # pitch/energy bucket count

    # ---- mel geometry (GGUF KV: max_seq_len / audio.*) ----
    max_seq_len: int = 1500          # static mel-frame cap (padded / truncated)
    num_mels: int = 80
    hop_size: int = 300
    sampling_rate: int = 24000

    # ---- StyleTTS decoder (reference: src/zerovox.cpp:119-125) ----
    residual_dim: int = 64

    # ---- HiFi-GAN vocoder (reference: src/zerovox.cpp:127-134) ----
    hifigan_channels: int = 512
    hifigan_kernel_size: int = 7
    upsample_scales: Tuple[int, ...] = (5, 5, 4, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (10, 10, 8, 6)
    num_resblocks: int = 3
    resblock_kernel_size: int = 3
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    # ---- numerics ----
    # "float32": full parity with the ggml reference (its f32 accumulation path).
    # "bfloat16": the bf16 serving path (TTSEngine(precision="bfloat16")).
    compute_dtype: str = "float32"
    layer_norm_eps: float = 1e-5
    instance_norm_eps: float = 1e-5
    # Reference MHA attends freely over padding (src/fs2encoder.cpp:103-110 has
    # no mask).  Keep that for bit parity; set True for the corrected behaviour.
    use_attention_mask: bool = False
    # The JAX package's vocoder implementation switch; kept for exact GGUF
    # round trips, unused by the port: its vocoder always runs the MRF-stage
    # kernel on a card and the kernel's plain version on the CPU.
    vocoder_backend: str = "auto"
    # A TPU layout switch of the JAX package; kept for exact GGUF round
    # trips, unused by the port (its kernel fuses every upsample).
    vocoder_fuse_a_upsample: bool = False

    # ------------------------------------------------------------------ derived
    @property
    def d_model(self) -> int:
        """Encoder hidden size: word-emb dim + punct-emb dim (528)."""
        return self.emb_dim + self.punct_emb_dim

    @property
    def d_k(self) -> int:
        return self.d_model // self.encoder_head

    @property
    def style_dim(self) -> int:
        return self.d_model

    @property
    def bottleneck_dim(self) -> int:
        """StyleTTS decoder bottleneck = 2 * dim_in (1056)."""
        return 2 * self.d_model

    @property
    def total_upsample(self) -> int:
        p = 1
        for s in self.upsample_scales:
            p *= s
        return p

    @property
    def wav_len(self) -> int:
        return self.max_seq_len * self.hop_size

    @property
    def audio_seconds(self) -> float:
        return self.wav_len / self.sampling_rate

    def __post_init__(self):
        if self.d_model % self.encoder_head != 0:
            raise ValueError(
                f"d_model={self.d_model} not divisible by encoder_head={self.encoder_head}")
        if self.total_upsample != self.hop_size:
            raise ValueError(
                f"prod(upsample_scales)={self.total_upsample} != hop_size={self.hop_size}")
        if len(self.upsample_scales) != len(self.upsample_kernel_sizes):
            raise ValueError("upsample_scales / upsample_kernel_sizes length mismatch")

    # ------------------------------------------------------------- serialisation
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ZeroVoxConfig":
        d = json.loads(s)
        for k in ("conv_kernel_size", "upsample_scales", "upsample_kernel_sizes"):
            if k in d:
                d[k] = tuple(d[k])
        if "resblock_dilations" in d:
            d["resblock_dilations"] = tuple(tuple(x) for x in d["resblock_dilations"])
        return cls(**d)

    def replace(self, **kw) -> "ZeroVoxConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------ GGUF KV integration
    GGUF_ARCH = "zerovox-resnet-fs2-styletts"

    # Extension KV carrying the full config (tier-2 constants included) so our
    # own checkpoints round-trip exactly; absent in reference-produced files,
    # where the defaults reproduce the reference's hardcoded values.
    GGUF_CONFIG_KEY = "zerovox-resnet-fs2-styletts.tpu.config_json"

    @classmethod
    def from_gguf_kv(cls, kv: dict, **overrides) -> "ZeroVoxConfig":
        """Build a config from GGUF metadata (the 14 uint32 hparams the
        reference reads, src/zerovox.cpp:39-56)."""
        if cls.GGUF_CONFIG_KEY in kv:
            cfg = cls.from_json(kv[cls.GGUF_CONFIG_KEY])
            return cfg.replace(**overrides) if overrides else cfg
        a = cls.GGUF_ARCH
        def g(key, default):
            return kv.get(f"{a}.{key}", default)
        base = cls()
        cfg = dict(
            max_seq_len=g("max_seq_len", base.max_seq_len),
            emb_dim=g("emb_dim", base.emb_dim),
            punct_emb_dim=g("punct_emb_dim", base.punct_emb_dim),
            conv_filter_size=g("decoder.conv_filter_size", base.conv_filter_size),
            conv_kernel_size=(
                g("decoder.conv_kernel_size.0", base.conv_kernel_size[0]),
                g("decoder.conv_kernel_size.1", base.conv_kernel_size[1]),
            ),
            encoder_layer=g("encoder.layer", base.encoder_layer),
            encoder_head=g("encoder.head", base.encoder_head),
            vp_filter_size=g("encoder.vp_filter_size", base.vp_filter_size),
            vp_kernel_size=g("encoder.vp_kernel_size", base.vp_kernel_size),
            ve_n_bins=g("encoder.ve_n_bins", base.ve_n_bins),
            sampling_rate=g("audio.sampling_rate", base.sampling_rate),
            num_mels=g("audio.num_mels", base.num_mels),
            hop_size=g("audio.hop_size", base.hop_size),
        )
        cfg.update(overrides)
        return cls(**cfg)

    def to_gguf_kv(self) -> dict:
        a = self.GGUF_ARCH
        return {
            f"{a}.max_seq_len": self.max_seq_len,
            f"{a}.emb_dim": self.emb_dim,
            f"{a}.punct_emb_dim": self.punct_emb_dim,
            f"{a}.decoder.n_head": self.encoder_head,
            f"{a}.decoder.conv_filter_size": self.conv_filter_size,
            f"{a}.decoder.conv_kernel_size.0": self.conv_kernel_size[0],
            f"{a}.decoder.conv_kernel_size.1": self.conv_kernel_size[1],
            f"{a}.encoder.layer": self.encoder_layer,
            f"{a}.encoder.head": self.encoder_head,
            f"{a}.encoder.vp_filter_size": self.vp_filter_size,
            f"{a}.encoder.vp_kernel_size": self.vp_kernel_size,
            f"{a}.encoder.ve_n_bins": self.ve_n_bins,
            f"{a}.audio.sampling_rate": self.sampling_rate,
            f"{a}.audio.num_mels": self.num_mels,
            f"{a}.audio.hop_size": self.hop_size,
        }


# A small config for fast tests / CI smoke (CPU-runnable in seconds).
TINY_CONFIG = ZeroVoxConfig(
    num_phonemes=40,
    num_puncts=6,
    max_n_phonemes=16,
    emb_dim=48,
    punct_emb_dim=8,
    encoder_layer=2,
    encoder_head=2,
    conv_filter_size=64,
    conv_kernel_size=(9, 1),
    vp_filter_size=32,
    vp_kernel_size=3,
    ve_n_bins=16,
    max_seq_len=64,
    num_mels=20,
    hop_size=60,
    sampling_rate=24000,
    residual_dim=16,
    hifigan_channels=32,
    upsample_scales=(5, 4, 3),
    upsample_kernel_sizes=(10, 8, 6),
    num_resblocks=2,
    resblock_dilations=((1, 3), (1, 3)),
)
