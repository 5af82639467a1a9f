"""Weights made from the seed, as GGUF-named arrays.

The benchmark makes the weights itself and hands the same arrays to the
program (`params.params_from_arrays`) and to the plain reference.  The names
and shapes are a frozen copy of the port's GGUF name map (the zerovox.cpp
exporter's names and layouts: Linear (out, in), Conv1d (out, in, K), the
ConvTranspose1d kernels pre-flipped as (out, in, K), the variance
predictors' output Linear flat); the weights follow the port's
`init_params` scales (normal, std 1/sqrt(fan_in); the sinusoid table).
Biases (the mel mean among them) are drawn from N(0, bias_std^2) and norm
gains (the mel scale among them) from 1 + N(0, gain_std^2), both from the
configuration's `assumed`, where the port's init sets 0 and 1: so that no
bias add and no affine is a no-op, and a program that drops, doubles or
misplaces one does not give the same answer.  Every normal leaf is drawn on
the device by one `torch.Generator` in one call and rounded to the dtype
they are served in.

The configuration's `assumed` block sets the variance predictors' output
heads (see the configuration files): the duration head's bias raised so
that random weights speak at a natural rate, and each head's spread kept
inside one duration or bucket step, so that every discrete decision of the
variance adaptor has a margin that rounding cannot cross.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference.geometry import resblock_kernel_sizes

Leaf = Tuple[str, Tuple[int, ...], tuple]      # (GGUF name, shape, init)


def derived(m: dict) -> dict:
    """The configuration's sizes with its derived ones (d_model,
    bottleneck_dim, the vocoder's stage channels)."""
    d = dict(m)
    d["d_model"] = m["emb_dim"] + m["punct_emb_dim"]
    d["bottleneck_dim"] = 2 * d["d_model"]
    c = m["hifigan_channels"]
    d["stage_channels"] = [(c >> i, c >> (i + 1)) for i in range(len(m["upsample_scales"]))]
    return d


def decoder_block_dims(m: dict) -> List[Tuple[int, int]]:
    d, b, r = m["d_model"], m["bottleneck_dim"], m["residual_dim"]
    return [(b + r, b), (b + r, b), (b + r, d), (d, d), (d, d)]


def _normal(fan_in: int) -> tuple:
    return ("normal", 1.0 / max(1.0, float(np.sqrt(fan_in))), 0.0)


def leaves(m: dict, assumed: dict) -> List[Leaf]:
    """Every tensor of the model: GGUF name, GGUF shape, how it is drawn."""
    m = derived(m)
    d = m["d_model"]
    out: List[Leaf] = []
    bias_init = ("normal", assumed["bias_std"], 0.0)
    gain_init = ("normal", assumed["gain_std"], 1.0)

    def lin(name, n_in, n_out, bias=True):
        out.append((f"{name}.w", (n_out, n_in), _normal(n_in)))
        if bias:
            out.append((f"{name}.b", (n_out,), bias_init))

    def conv(name, n_in, n_out, k, bias=True):
        out.append((f"{name}.w", (n_out, n_in, k), _normal(k * n_in)))
        if bias:
            out.append((f"{name}.b", (n_out,), bias_init))

    def norm(name, n):
        out.append((f"{name}.w", (n,), gain_init))
        out.append((f"{name}.b", (n,), bias_init))

    out.append(("_pe._enc.src_word_emb.w", (m["num_phonemes"] + 1, m["emb_dim"]),
                _normal(m["num_phonemes"] + 1)))
    out.append(("_pe._enc.punct_embed.w", (m["num_puncts"] + 1, m["punct_emb_dim"]),
                _normal(m["num_puncts"] + 1)))
    out.append(("sinusoid_encoding_table", (m["max_seq_len"] + 1, d), ("sinusoid",)))
    k0, k1 = m["conv_kernel_size"]
    for i in range(m["encoder_layer"]):
        pre = f"_pe._enc.laystk.{i}"
        for w in ("w_qs", "w_ks", "w_vs", "fc"):
            lin(f"{pre}.slf_attn.{w}", d, d)
        norm(f"{pre}.slf_attn.layer_norm", d)
        conv(f"{pre}.pos_ffn.w_1", d, m["conv_filter_size"], k0)
        conv(f"{pre}.pos_ffn.w_2", m["conv_filter_size"], d, k1)
        norm(f"{pre}.pos_ffn.layer_norm", d)
    f, k = m["vp_filter_size"], m["vp_kernel_size"]
    heads = {"duration_predictor": ("duration", "bias"),
             "pitch_predictor": ("pitch", "bucket"),
             "engy_pred": ("energy", "bucket")}
    for theirs, (what, kind) in heads.items():
        pre = f"_pe._var_adapt.{theirs}"
        conv(f"{pre}.conv_layer.conv1d_1.conv", d, f, k)
        conv(f"{pre}.conv_layer.conv1d_2.conv", f, f, k)
        norm(f"{pre}.conv_layer.layer_norm_1", f)
        norm(f"{pre}.conv_layer.layer_norm_2", f)
        # the head reads a layer-normed input (unit variance a channel), so
        # a std of s/sqrt(f) gives the head's output a spread of s
        out.append((f"{pre}.linear_layer.w", (f,),
                    ("normal", assumed[f"{what}_head_spread"] / float(np.sqrt(f)), 0.0)))
        if kind == "bias":
            bias = assumed["duration_head_bias"]
        else:
            bias = assumed[f"{what}_bucket"] / (m["ve_n_bins"] - 1)
        out.append((f"{pre}.linear_layer.b", (1,), ("const", bias)))
    out.append(("_pe._var_adapt.pitch_embedding.w", (m["ve_n_bins"], d), _normal(m["ve_n_bins"])))
    out.append(("_pe._var_adapt.energy_embedding.w", (m["ve_n_bins"], d), _normal(m["ve_n_bins"])))

    b = m["bottleneck_dim"]
    for idx, (ci, co) in enumerate(((d, b), (b, b))):
        pre = f"_mel_decoder.encode.{idx}"
        conv(f"{pre}.conv1", ci, ci, 3)
        conv(f"{pre}.conv2", ci, co, 3)
        norm(f"{pre}.norm1", ci)
        norm(f"{pre}.norm2", ci)
        if ci != co:
            conv(f"{pre}.conv1x1", ci, co, 1, bias=False)
    conv("_mel_decoder.asr_res.0", d, m["residual_dim"], 1)
    norm("_mel_decoder.asr_res.1", m["residual_dim"])
    for idx, (ci, co) in enumerate(decoder_block_dims(m)):
        pre = f"_mel_decoder.decode.{idx}"
        lin(f"{pre}.norm1.fc", d, 2 * ci)
        lin(f"{pre}.norm2.fc", d, 2 * co)
        conv(f"{pre}.conv1", ci, co, 3)
        conv(f"{pre}.conv2", co, co, 3)
        if ci != co:
            conv(f"{pre}.conv1x1", ci, co, 1, bias=False)
    conv("_mel_decoder.to_out.0", d, m["num_mels"], 1)

    c = m["hifigan_channels"]
    out.append(("hifigan.mean", (m["num_mels"],), bias_init))
    out.append(("hifigan.scale", (m["num_mels"],), gain_init))
    conv("_meldec.input_conv", m["num_mels"], c, m["hifigan_kernel_size"])
    c_last = m["stage_channels"][-1][1]
    conv("_meldec.output_conv.1", c_last, 1, m["hifigan_kernel_size"])
    rks = resblock_kernel_sizes(m)
    nrb = len(rks)
    for i, (ci, co) in enumerate(m["stage_channels"]):
        conv(f"_meldec.upsamples.{i}.1", ci, co, m["upsample_kernel_sizes"][i])
        for j, rk in enumerate(rks):
            bidx = i * nrb + j
            for dd in range(len(m["resblock_dilations"][j])):
                for cset in ("convs1", "convs2"):
                    conv(f"_meldec.blocks.{bidx}.{cset}.{dd}.1", co, co, rk)
    return out


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """The exporter's sinusoid position table."""
    hid = np.arange(d_hid)
    denom = np.power(10000.0, 2 * (hid // 2) / d_hid)
    table = (np.arange(n_position)[:, None] / denom[None, :]).astype(np.float32)
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table


def draw(m: dict, assumed: dict, seed: int, device, dtype) -> Dict[str, np.ndarray]:
    """{GGUF name: float32 array} for `seed`: every normal leaf from one
    torch.Generator call on `device`, scaled and offset per leaf, rounded to
    `dtype` (the dtype the configuration serves in) and copied to the host
    once."""
    import torch
    from benchmark.traffic import SEED_MASK
    specs = leaves(m, assumed)
    n = sum(int(np.prod(shape)) for _, shape, init in specs if init[0] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    normal = [(int(np.prod(shape)), init[1], init[2]) for _, shape, init in specs
              if init[0] == "normal"]
    counts = torch.tensor([c for c, _, _ in normal], device=device)

    def per_leaf(i):
        return torch.repeat_interleave(
            torch.tensor([v[i] for v in normal], device=device, dtype=torch.float32), counts)

    flat = (flat * per_leaf(1) + per_leaf(2)).to(dtype).to(torch.float32).cpu().numpy()

    def served(a: np.ndarray) -> np.ndarray:
        return torch.from_numpy(a).to(dtype).to(torch.float32).numpy()

    arrays: Dict[str, np.ndarray] = {}
    at = 0
    for name, shape, init in specs:
        size = int(np.prod(shape))
        if init[0] == "normal":
            arrays[name] = flat[at:at + size].reshape(shape)
            at += size
        elif init[0] == "const":
            arrays[name] = served(np.full(shape, init[1], np.float32))
        else:
            arrays[name] = served(sinusoid_table(*shape))
    return arrays
