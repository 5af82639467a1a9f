"""The plain reference: zerovox medium-ldec in float32, one utterance at a time.

FastSpeech2 encoder (embeddings + sinusoid positions, FFT blocks of
unmasked multi-head attention and a conv feed-forward), the variance
adaptor (duration, pitch and energy predictors, bucketized embeddings), the
length regulator, the StyleTTS decoder (ResBlk1d and AdainResBlk1d with
instance norms over time) and the HiFi-GAN vocoder (upsample, multi-
receptive-field resblocks, tanh), then PCM16 as the daemon quantises it
(clip to [-1, 1], times 32767, truncated toward zero).

Plain torch only: F.conv1d, F.conv_transpose1d, matmuls, on the GGUF-named
arrays the benchmark made (benchmark.weights).  It imports nothing of the
program; it works out every derived quantity (durations, buckets, mel_len)
itself.  Activations are channels-first (C, T) of one utterance.

`precision` selects the arithmetic of every product (convolutions, linear
layers, the attention's two matmuls): "float32" (TF32 off: the
reference), "tf32" (both operands rounded to TF32's 10-bit mantissa, the
products and sums in float32) and "fp8" (both operands scaled per tensor
into float8 e4m3 and rounded): the last two are the controls, the nearest
precisions below float32 and bfloat16 that a later change could reach for.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import resblock_kernel_sizes

FP8_MAX = 448.0


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest even at TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 values scaled per tensor into e4m3's range and rounded."""
    amax = t.abs().amax()
    if float(amax) == 0.0:
        return t
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


OPERAND: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "float32": lambda t: t, "tf32": round_tf32, "fp8": round_fp8}


class Reference:
    """The model on `device`, from the GGUF-named arrays, in float32."""

    def __init__(self, arrays: Dict[str, np.ndarray], model: dict, device,
                 precision: str = "float32"):
        self.m = model
        self.d_model = model["emb_dim"] + model["punct_emb_dim"]
        self.w = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                  for k, v in arrays.items()}
        self.device = device
        if torch.device(device).type == "cuda":     # float32 means float32: no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.op = OPERAND[precision]
        self.eps = 1e-5

    # ---------------------------------------------------------- products
    def conv(self, x, name, padding=0, dilation=1, bias=True):
        """x (C_in, T) -> (C_out, T') through the conv `name` ((out, in, K))."""
        w = self.op(self.w[name + ".w"])
        y = F.conv1d(self.op(x)[None], w, None, padding=padding, dilation=dilation)[0]
        return y + self.w[name + ".b"][:, None] if bias else y

    def linear(self, x, name, bias=True):
        """x (..., in) -> (..., out) through the Linear `name` ((out, in))."""
        y = self.op(x) @ self.op(self.w[name + ".w"]).t()
        return y + self.w[name + ".b"] if bias else y

    def upsample(self, x, i):
        """ConvTranspose1d of stage i from its flipped export kernel."""
        s = self.m["upsample_scales"][i]
        w = self.w[f"_meldec.upsamples.{i}.1.w"].flip(-1).transpose(0, 1)
        y = F.conv_transpose1d(self.op(x)[None], self.op(w), None, stride=s,
                               padding=s // 2 + s % 2, output_padding=s % 2)[0]
        return y + self.w[f"_meldec.upsamples.{i}.1.b"][:, None]

    # ------------------------------------------------------------- norms
    def layer_norm(self, x, name):
        """Over channels of (T, C)."""
        mu = x.mean(-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(-1, keepdim=True)
        return xc / torch.sqrt(var + self.eps) * self.w[name + ".w"] + self.w[name + ".b"]

    def instance_norm(self, x, name=None):
        """Over time of (C, T), per channel, with an optional affine."""
        mu = x.mean(-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(-1, keepdim=True)
        y = xc / torch.sqrt(var + self.eps)
        if name is None:
            return y
        return y * self.w[name + ".w"][:, None] + self.w[name + ".b"][:, None]

    # ----------------------------------------------------------- encoder
    def attention(self, x, pre):
        """(T, C) self-attention block with residual and LayerNorm."""
        T, C = x.shape
        h = self.m["encoder_head"]
        dk = C // h
        q, k, v = (self.linear(x, f"{pre}.{n}").reshape(T, h, dk).transpose(0, 1)
                   for n in ("w_qs", "w_ks", "w_vs"))
        a = (self.op(q) @ self.op(k).transpose(-1, -2)) * (1.0 / math.sqrt(dk))
        a = torch.softmax(a, dim=-1)
        o = (self.op(a) @ self.op(v)).transpose(0, 1).reshape(T, C)
        return self.layer_norm(self.linear(o, f"{pre}.fc") + x, f"{pre}.layer_norm")

    def fft_block(self, x, i):
        pre = f"_pe._enc.laystk.{i}"
        x = self.attention(x, f"{pre}.slf_attn")
        k0, k1 = self.m["conv_kernel_size"]
        h = torch.relu(self.conv(x.t(), f"{pre}.pos_ffn.w_1", padding=(k0 - 1) // 2))
        h = self.conv(h, f"{pre}.pos_ffn.w_2", padding=(k1 - 1) // 2).t()
        return self.layer_norm(h + x, f"{pre}.pos_ffn.layer_norm")

    def predictor(self, x, name):
        """(T, C) -> (T,): conv, ReLU, LN, conv, ReLU, LN, Linear."""
        pre = f"_pe._var_adapt.{name}"
        pad = (self.m["vp_kernel_size"] - 1) // 2
        h = torch.relu(self.conv(x.t(), f"{pre}.conv_layer.conv1d_1.conv", padding=pad)).t()
        h = self.layer_norm(h, f"{pre}.conv_layer.layer_norm_1")
        h = torch.relu(self.conv(h.t(), f"{pre}.conv_layer.conv1d_2.conv", padding=pad)).t()
        h = self.layer_norm(h, f"{pre}.conv_layer.layer_norm_2")
        w = self.w[f"{pre}.linear_layer.w"]
        return (self.op(h) @ self.op(w)) + self.w[f"{pre}.linear_layer.b"][0]

    def bucketize(self, p):
        top = self.m["ve_n_bins"] - 1
        return torch.clamp(torch.floor(p * top + 0.5), 0, top).long()

    def encode(self, ph, pu, style):
        """Padded ids (P,), style (C,) -> features (P, C), log durations (P,),
        and the pre-bucket pitch and energy (P,)."""
        x = torch.cat([self.w["_pe._enc.src_word_emb.w"][ph],
                       self.w["_pe._enc.punct_embed.w"][pu]], dim=-1)
        x = x + self.w["sinusoid_encoding_table"][:ph.shape[0]]
        for i in range(self.m["encoder_layer"]):
            x = self.fft_block(x, i)
        x = x + style[None, :]
        log_dur = self.predictor(x, "duration_predictor")
        pitch = self.predictor(x, "pitch_predictor")
        x = x + self.w["_pe._var_adapt.pitch_embedding.w"][self.bucketize(pitch)]
        energy = self.predictor(x, "engy_pred")
        x = x + self.w["_pe._var_adapt.energy_embedding.w"][self.bucketize(energy)]
        return x, log_dur, pitch, energy

    def length_regulate(self, x, log_dur, n):
        """Repeat each of the first n phonemes floor(exp(d) - 0.5) times,
        truncate at max_seq_len, zero-pad: (T, C) and mel_len."""
        T = self.m["max_seq_len"]
        dur = torch.clamp(torch.floor(torch.exp(log_dur) - 0.5), 0, T).long()
        dur[n:] = 0
        frames = torch.repeat_interleave(x, dur, dim=0)[:T]
        out = torch.zeros((T, x.shape[1]), device=x.device)
        out[:frames.shape[0]] = frames
        return out, int(frames.shape[0])

    # ----------------------------------------------------------- decoder
    def res_blk(self, x, pre, shortcut_conv):
        sc = self.conv(x, f"{pre}.conv1x1", bias=False) if shortcut_conv else x
        h = F.leaky_relu(self.instance_norm(x, f"{pre}.norm1"), 0.2)
        h = self.conv(h, f"{pre}.conv1", padding=1)
        h = F.leaky_relu(self.instance_norm(h, f"{pre}.norm2"), 0.2)
        h = self.conv(h, f"{pre}.conv2", padding=1)
        return (h + sc) * (1.0 / math.sqrt(2.0))

    def adain(self, x, style, name):
        g = self.linear(style, name)
        c = g.shape[-1] // 2
        return (1.0 + g[:c])[:, None] * self.instance_norm(x) + g[c:][:, None]

    def adain_blk(self, x, style, pre, shortcut_conv):
        h = F.leaky_relu(self.adain(x, style, f"{pre}.norm1.fc"), 0.2)
        h = self.conv(h, f"{pre}.conv1", padding=1)
        h = F.leaky_relu(self.adain(h, style, f"{pre}.norm2.fc"), 0.2)
        h = self.conv(h, f"{pre}.conv2", padding=1)
        sc = self.conv(x, f"{pre}.conv1x1", bias=False) if shortcut_conv else x
        return (h + sc) * (1.0 / math.sqrt(2.0))

    def decode(self, hidden, style):
        """hidden (C, T) -> mel (num_mels, T)."""
        has = lambda pre: f"{pre}.conv1x1.w" in self.w            # noqa: E731
        x = self.res_blk(hidden, "_mel_decoder.encode.0", has("_mel_decoder.encode.0"))
        x = self.res_blk(x, "_mel_decoder.encode.1", has("_mel_decoder.encode.1"))
        asr = self.instance_norm(self.conv(hidden, "_mel_decoder.asr_res.0"),
                                 "_mel_decoder.asr_res.1")
        for i in range(5):
            pre = f"_mel_decoder.decode.{i}"
            if i < 3:
                x = torch.cat([x, asr], dim=0)
            x = self.adain_blk(x, style, pre, has(pre))
        return self.conv(x, "_mel_decoder.to_out.0")

    # ----------------------------------------------------------- vocoder
    def vocode(self, mel):
        """mel (num_mels, T) -> waveform (T * hop,) in [-1, 1]."""
        m = self.m
        k = m["hifigan_kernel_size"]
        x = (mel - self.w["hifigan.mean"][:, None]) / self.w["hifigan.scale"][:, None]
        x = self.conv(x, "_meldec.input_conv", padding=(k - 1) // 2)
        rks = resblock_kernel_sizes(m)
        nrb = len(rks)
        n_st = len(m["upsample_scales"])
        for i in range(n_st):
            x = self.upsample(F.leaky_relu(x, 0.1), i)
            acc = 0
            for j, rk in enumerate(rks):
                r = x
                for dd, dil in enumerate(m["resblock_dilations"][j]):
                    pre = f"_meldec.blocks.{i * nrb + j}"
                    t = self.conv(F.leaky_relu(r, 0.1), f"{pre}.convs1.{dd}.1",
                                  padding=(rk - 1) // 2 * dil, dilation=dil)
                    t = self.conv(F.leaky_relu(t, 0.1), f"{pre}.convs2.{dd}.1",
                                  padding=(rk - 1) // 2)
                    r = r + t
                acc = acc + r
            x = acc * (1.0 / nrb)
        x = F.leaky_relu(x, 0.01)
        y = torch.tanh(self.conv(x, "_meldec.output_conv.1", padding=(k - 1) // 2))
        return y[0, :mel.shape[1] * m["hop_size"]]

    # --------------------------------------------------------------- API
    @torch.inference_mode()
    def synthesize(self, phonemes, puncts, style) -> dict:
        """One utterance (unpadded ids and puncts, the style vector) ->
        {"pcm": int16 (max_seq_len * hop,), "mel_len": int, "margins": the
        smallest distance, in steps, of any duration, pitch or energy
        decision of the utterance from a rounding boundary}."""
        P = self.m["max_n_phonemes"]
        n = len(phonemes)
        ph = torch.zeros(P, dtype=torch.long, device=self.device)
        pu = torch.zeros(P, dtype=torch.long, device=self.device)
        ph[:n] = torch.as_tensor(np.asarray(phonemes), device=self.device).long()
        pu[:n] = torch.as_tensor(np.asarray(puncts), device=self.device).long()
        st = torch.as_tensor(np.asarray(style, np.float32), device=self.device)
        x, log_dur, pitch, energy = self.encode(ph, pu, st)
        hidden, mel_len = self.length_regulate(x, log_dur, n)
        mel = self.decode(hidden.t(), st)
        wav = self.vocode(mel)
        pcm = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        top = self.m["ve_n_bins"] - 1

        def margin(v):                     # distance of v from the nearest .5 step edge
            frac = v - torch.floor(v)
            return float(torch.min(torch.minimum(frac, 1 - frac)))

        return {"pcm": pcm.cpu().numpy(), "mel_len": mel_len,
                "margins": {"duration": margin(torch.exp(log_dur[:n]) - 0.5),
                            "pitch": margin(pitch * top + 0.5),
                            "energy": margin(energy * top + 0.5)}}
