"""Parameter trees + GGUF name mapping (the port's counterpart of zerovox_tpu/params.py).

The tree is a nested dict (lists for layer stacks) of torch tensors with the
same paths as the JAX package's tree, e.g. ``("vocoder", "blocks", 3,
"convs1", 1, "w")``.

Layout decision, made once here: every leaf keeps the GGUF's own
(numpy-order) layout, which is already PyTorch's layout, so no conversion
happens anywhere else:

  GGUF / port tree                        used by
  Linear  w: (out, in)                    F.linear
  Conv1d  w: (out, in, K)                 F.conv1d
  ConvT1d w: (out, in, K), pre-flipped    ops.conv.conv_transpose1d and the
                                          MRF kernel (both unflip it)
  variance-predictor linear: (1, filter)  F.linear (stored flat in the GGUF)
  embeddings / vectors                    unchanged

The JAX tree stores the same values transposed ((in, out), (K, in, out));
`params_to_arrays` of either package yields identical GGUF-named arrays, so
carrying weights across is
``params_from_arrays(zerovox_tpu.params.params_to_arrays(p_jax, cfg), cfg, device)``.
`init_params` draws in the JAX package's layout and order and then
transposes, so one seed gives bitwise the same weights in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .config import ZeroVoxConfig
from .device import resolve_device
from .ops.misc import sinusoid_encoding_table

# layout kinds of the name map (GGUF array -> tree leaf)
_LINEAR = "linear"        # (out, in), drawn as (in, out) by init_params
_CONV = "conv"            # (out, in, K), drawn as (K, in, out)
_VP_LIN = "vp_lin"        # flat (filter,) in the GGUF, (1, filter) in the tree


# --------------------------------------------------------------------------
# GGUF name map: tree path (tuple) -> (gguf name, layout kind)
# --------------------------------------------------------------------------

def gguf_name_map(cfg: ZeroVoxConfig) -> Dict[tuple, tuple]:
    """Tree path -> (GGUF name, layout kind), in the JAX package's order."""
    m: Dict[tuple, tuple] = {}

    def add(path, name, kind=None):
        m[path] = (name, kind)

    # ---- FastSpeech2 encoder --------------------------------------------
    add(("encoder", "word_emb"), "_pe._enc.src_word_emb.w")
    add(("encoder", "punct_emb"), "_pe._enc.punct_embed.w")
    add(("encoder", "pos_table"), "sinusoid_encoding_table")
    for i in range(cfg.encoder_layer):
        pre = f"_pe._enc.laystk.{i}"
        for ours, theirs in (("wq", "w_qs"), ("wk", "w_ks"), ("wv", "w_vs"), ("wo", "fc")):
            add(("encoder", "layers", i, "attn", ours), f"{pre}.slf_attn.{theirs}.w", _LINEAR)
            add(("encoder", "layers", i, "attn", "b" + ours[1]), f"{pre}.slf_attn.{theirs}.b")
        add(("encoder", "layers", i, "attn", "ln_g"), f"{pre}.slf_attn.layer_norm.w")
        add(("encoder", "layers", i, "attn", "ln_b"), f"{pre}.slf_attn.layer_norm.b")
        add(("encoder", "layers", i, "ffn", "w1"), f"{pre}.pos_ffn.w_1.w", _CONV)
        add(("encoder", "layers", i, "ffn", "b1"), f"{pre}.pos_ffn.w_1.b")
        add(("encoder", "layers", i, "ffn", "w2"), f"{pre}.pos_ffn.w_2.w", _CONV)
        add(("encoder", "layers", i, "ffn", "b2"), f"{pre}.pos_ffn.w_2.b")
        add(("encoder", "layers", i, "ffn", "ln_g"), f"{pre}.pos_ffn.layer_norm.w")
        add(("encoder", "layers", i, "ffn", "ln_b"), f"{pre}.pos_ffn.layer_norm.b")

    for ours, theirs in (("duration_predictor", "duration_predictor"),
                         ("pitch_predictor", "pitch_predictor"),
                         ("energy_predictor", "engy_pred")):
        pre = f"_pe._var_adapt.{theirs}"
        add(("encoder", ours, "conv1_w"), f"{pre}.conv_layer.conv1d_1.conv.w", _CONV)
        add(("encoder", ours, "conv1_b"), f"{pre}.conv_layer.conv1d_1.conv.b")
        add(("encoder", ours, "conv2_w"), f"{pre}.conv_layer.conv1d_2.conv.w", _CONV)
        add(("encoder", ours, "conv2_b"), f"{pre}.conv_layer.conv1d_2.conv.b")
        add(("encoder", ours, "ln1_g"), f"{pre}.conv_layer.layer_norm_1.w")
        add(("encoder", ours, "ln1_b"), f"{pre}.conv_layer.layer_norm_1.b")
        add(("encoder", ours, "ln2_g"), f"{pre}.conv_layer.layer_norm_2.w")
        add(("encoder", ours, "ln2_b"), f"{pre}.conv_layer.layer_norm_2.b")
        add(("encoder", ours, "lin_w"), f"{pre}.linear_layer.w", _VP_LIN)
        add(("encoder", ours, "lin_b"), f"{pre}.linear_layer.b")

    add(("encoder", "pitch_emb"), "_pe._var_adapt.pitch_embedding.w")
    add(("encoder", "energy_emb"), "_pe._var_adapt.energy_embedding.w")

    # ---- StyleTTS decoder ------------------------------------------------
    dim_in = cfg.d_model
    bdim = cfg.bottleneck_dim
    for idx, (ci, co) in enumerate(((dim_in, bdim), (bdim, bdim))):
        pre = f"_mel_decoder.encode.{idx}"
        blk = ("decoder", f"encode{idx}")
        add(blk + ("conv1_w",), f"{pre}.conv1.w", _CONV)
        add(blk + ("conv1_b",), f"{pre}.conv1.b")
        add(blk + ("conv2_w",), f"{pre}.conv2.w", _CONV)
        add(blk + ("conv2_b",), f"{pre}.conv2.b")
        add(blk + ("norm1_g",), f"{pre}.norm1.w")
        add(blk + ("norm1_b",), f"{pre}.norm1.b")
        add(blk + ("norm2_g",), f"{pre}.norm2.w")
        add(blk + ("norm2_b",), f"{pre}.norm2.b")
        if ci != co:
            add(blk + ("conv1x1_w",), f"{pre}.conv1x1.w", _CONV)

    add(("decoder", "asr_res", "conv_w"), "_mel_decoder.asr_res.0.w", _CONV)
    add(("decoder", "asr_res", "conv_b"), "_mel_decoder.asr_res.0.b")
    add(("decoder", "asr_res", "norm_g"), "_mel_decoder.asr_res.1.w")
    add(("decoder", "asr_res", "norm_b"), "_mel_decoder.asr_res.1.b")

    for idx, (ci, co) in enumerate(decoder_block_dims(cfg)):
        pre = f"_mel_decoder.decode.{idx}"
        blk = ("decoder", f"decode{idx}")
        add(blk + ("fc1_w",), f"{pre}.norm1.fc.w", _LINEAR)
        add(blk + ("fc1_b",), f"{pre}.norm1.fc.b")
        add(blk + ("fc2_w",), f"{pre}.norm2.fc.w", _LINEAR)
        add(blk + ("fc2_b",), f"{pre}.norm2.fc.b")
        add(blk + ("conv1_w",), f"{pre}.conv1.w", _CONV)
        add(blk + ("conv1_b",), f"{pre}.conv1.b")
        add(blk + ("conv2_w",), f"{pre}.conv2.w", _CONV)
        add(blk + ("conv2_b",), f"{pre}.conv2.b")
        if ci != co:
            add(blk + ("conv1x1_w",), f"{pre}.conv1x1.w", _CONV)

    add(("decoder", "to_out", "conv_w"), "_mel_decoder.to_out.0.w", _CONV)
    add(("decoder", "to_out", "conv_b"), "_mel_decoder.to_out.0.b")

    # ---- HiFi-GAN vocoder ------------------------------------------------
    add(("vocoder", "mean"), "hifigan.mean")
    add(("vocoder", "scale"), "hifigan.scale")
    add(("vocoder", "input_conv_w"), "_meldec.input_conv.w", _CONV)
    add(("vocoder", "input_conv_b"), "_meldec.input_conv.b")
    add(("vocoder", "output_conv_w"), "_meldec.output_conv.1.w", _CONV)
    add(("vocoder", "output_conv_b"), "_meldec.output_conv.1.b")
    for i in range(len(cfg.upsample_scales)):
        # stored flipped + permuted at export: (out, in, K)
        add(("vocoder", "upsamples", i, "w"), f"_meldec.upsamples.{i}.1.w", _CONV)
        add(("vocoder", "upsamples", i, "b"), f"_meldec.upsamples.{i}.1.b")
        for j in range(cfg.num_resblocks):
            bidx = i * cfg.num_resblocks + j
            for d in range(len(cfg.resblock_dilations[j])):
                for cset in ("convs1", "convs2"):
                    add(("vocoder", "blocks", bidx, cset, d, "w"),
                        f"_meldec.blocks.{bidx}.{cset}.{d}.1.w", _CONV)
                    add(("vocoder", "blocks", bidx, cset, d, "b"),
                        f"_meldec.blocks.{bidx}.{cset}.{d}.1.b")
    return m


def conv_kernel_names(cfg: ZeroVoxConfig) -> set:
    """GGUF names of the conv kernels (Conv1d and the pre-flipped
    ConvTranspose1d weights): the tensors the reference exporter stores f16."""
    return {name for name, kind in gguf_name_map(cfg).values() if kind == _CONV}


def decoder_block_dims(cfg: ZeroVoxConfig) -> List[tuple]:
    """(dim_in, dim_out) of the five AdainResBlk1d stages."""
    d, b, r = cfg.d_model, cfg.bottleneck_dim, cfg.residual_dim
    return [(b + r, b), (b + r, b), (b + r, d), (d, d), (d, d)]


def vocoder_stage_channels(cfg: ZeroVoxConfig) -> List[tuple]:
    """(C_in, C_out) per upsample stage (channels halve each stage)."""
    c = cfg.hifigan_channels
    return [(c // (2 ** i), c // (2 ** (i + 1)))
            for i in range(len(cfg.upsample_scales))]


# --------------------------------------------------------------------------
# tree plumbing
# --------------------------------------------------------------------------

def _set_path(tree: dict, path: tuple, value):
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt_key = path[i + 1]
        if isinstance(key, int):
            while len(node) <= key:
                node.append({} if not isinstance(nxt_key, int) else [])
            node = node[key]
        else:
            if key not in node:
                node[key] = [] if isinstance(nxt_key, int) else {}
            node = node[key]
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
    node[last] = value


def get_path(tree, path: tuple):
    node = tree
    for key in path:
        node = node[key]
    return node


def tree_map(fn, tree, *rest):
    """Apply `fn` to every tensor leaf of a nested dict/list tree, in
    tree_leaves order; with `rest`, trees of the same structure, fn also
    gets their leaves at the same path."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of a nested dict/list tree, in tree_map's order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def params_to_device(params: dict, device) -> dict:
    """The tree with every leaf moved to `device` (a no-op where it lies)."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)


def params_from_arrays(arrays: Dict[str, np.ndarray], cfg: ZeroVoxConfig,
                       device="cuda", dtype=torch.float32,
                       strict: bool = True) -> dict:
    """Build the tree from a {gguf_name: numpy array} dict (GGUF layouts)."""
    dev = resolve_device(device)
    tree: dict = {}
    missing = []
    for path, (name, kind) in gguf_name_map(cfg).items():
        if name not in arrays:
            missing.append(name)
            continue
        a = np.array(arrays[name], dtype=np.float32)     # a writable copy
        if kind == _VP_LIN:
            a = a.reshape(1, -1)
        _set_path(tree, path, torch.from_numpy(a).to(device=dev, dtype=dtype))
    if missing and strict:
        raise KeyError(f"{len(missing)} tensors missing from checkpoint, e.g. {missing[:5]}")
    return tree


def params_to_arrays(params: dict, cfg: ZeroVoxConfig) -> Dict[str, np.ndarray]:
    """Inverse of params_from_arrays (reference GGUF layouts/names)."""
    out: Dict[str, np.ndarray] = {}
    for path, (name, kind) in gguf_name_map(cfg).items():
        a = get_path(params, path).detach().to("cpu", torch.float32).numpy()
        if kind == _VP_LIN:
            a = a.reshape(-1)
        out[name] = np.ascontiguousarray(a)
    return out


def load_params(path: str, cfg: Optional[ZeroVoxConfig] = None,
                device="cuda", dtype=torch.float32, use_native: bool = True):
    """Load a GGUF checkpoint -> (config, params tree on `device`).

    The metadata is parsed by the Python reader; with use_native the tensor
    bytes go through the native mmap reader (io.native) where it is
    available, else (and for quantized tensors, which the numpy reader
    dequantizes to f32) through the numpy reader."""
    from .io.gguf import GGUFReader
    from .io import native
    dev = resolve_device(device)
    with GGUFReader(path) as r:
        if cfg is None:
            cfg = ZeroVoxConfig.from_gguf_kv(r.kv)
        arrays = None if use_native and native.available() else r.load_all(as_float32=True)
    if arrays is None:
        try:
            with native.NativeGGUF(path) as ng:
                arrays = ng.load_all(as_float32=True)
        except NotImplementedError:
            with GGUFReader(path) as r:
                arrays = r.load_all(as_float32=True)
    return cfg, params_from_arrays(arrays, cfg, device=dev, dtype=dtype)


def save_params(path: str, params: dict, cfg: ZeroVoxConfig,
                quantize: Optional[str] = None):
    """Write params + hparams to a reference-compatible GGUF file.

    The same file the JAX package's save_params writes: conv kernels
    (conv_kernel_names) stored f16 as the reference exporter does, and with
    quantize="q8_0" the large matrix/conv weights as 8-bit blocks."""
    from .io.gguf import GGUFWriter, GGMLType
    w = GGUFWriter(arch=cfg.GGUF_ARCH)
    for key, val in cfg.to_gguf_kv().items():
        w.add_uint32(key, val)
    w.add_kv(cfg.GGUF_CONFIG_KEY, cfg.to_json())
    convs = conv_kernel_names(cfg)
    for name, arr in params_to_arrays(params, cfg).items():
        quantizable = (arr.ndim >= 2 and arr.size % 32 == 0
                       and arr.size >= 4096 and "emb" not in name
                       and name != "sinusoid_encoding_table")
        if quantize == "q8_0" and quantizable:
            w.add_tensor(name, arr, ggml_type=GGMLType.Q8_0)
        elif name in convs:              # conv kernel -> f16 (reference cast)
            w.add_tensor(name, arr.astype(np.float16))
        else:
            w.add_tensor(name, arr)
    w.write(path)


# --------------------------------------------------------------------------
# random init (for tests / benches / synthetic checkpoints)
# --------------------------------------------------------------------------

def _from_draw_layout(a: np.ndarray, kind) -> np.ndarray:
    """A leaf drawn in the JAX package's layout -> the port's layout."""
    if kind == _LINEAR:
        return a.T
    if kind == _CONV:
        return a.transpose(2, 1, 0)
    if kind == _VP_LIN:
        return a.reshape(1, -1)
    return a


def init_params(cfg: ZeroVoxConfig, seed: int = 0, device="cuda",
                dtype=torch.float32) -> dict:
    """Random parameters with the exact reference shapes.

    Draws from np.random.default_rng(seed) in gguf_name_map order and in the
    JAX package's layout, so the weights equal zerovox_tpu.params.init_params'
    bitwise (duration bias included: random models then predict about two
    frames per phoneme instead of an empty mel).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tree: dict = {}

    def randn(shape, scale):
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    for path, (name, kind) in gguf_name_map(cfg).items():
        shape = _draw_shape(path, cfg)
        leaf = path[-1]
        if name == "sinusoid_encoding_table":
            val = sinusoid_encoding_table(*shape)
        elif path[:3] == ("encoder", "duration_predictor", "lin_b"):
            val = np.full(shape, 1.2, np.float32)
        elif path[:3] == ("encoder", "duration_predictor", "lin_w"):
            # keep the random head small so the duration bias dominates
            val = randn(shape, 0.1 / max(1.0, np.sqrt(shape[0])))
        elif leaf.endswith("_b") or leaf.startswith("b") or leaf in ("mean",):
            val = np.zeros(shape, np.float32)
        elif leaf in ("ln_g", "ln1_g", "ln2_g", "norm_g", "norm1_g", "norm2_g", "scale"):
            val = np.ones(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
            val = randn(shape, 1.0 / max(1.0, np.sqrt(fan_in)))
        val = np.ascontiguousarray(_from_draw_layout(val, kind))
        _set_path(tree, path, torch.from_numpy(val).to(device=dev, dtype=dtype))
    return tree


def _draw_shape(path: tuple, cfg: ZeroVoxConfig) -> tuple:
    """Shape of every parameter in the JAX package's layout (the layout in
    which init_params draws, so seeds match across the two packages)."""
    d = cfg.d_model
    section = path[0]
    leaf = path[-1]

    if section == "encoder":
        if path[1] == "word_emb":
            return (cfg.num_phonemes + 1, cfg.emb_dim)
        if path[1] == "punct_emb":
            return (cfg.num_puncts + 1, cfg.punct_emb_dim)
        if path[1] == "pos_table":
            return (cfg.max_seq_len + 1, d)
        if path[1] == "pitch_emb" or path[1] == "energy_emb":
            return (cfg.ve_n_bins, d)
        if path[1] == "layers":
            sub, leaf = path[3], path[4]
            if sub == "attn":
                if leaf in ("wq", "wk", "wv", "wo"):
                    return (d, d)
                return (d,)
            k0, k1 = cfg.conv_kernel_size
            h = cfg.conv_filter_size
            return {"w1": (k0, d, h), "b1": (h,), "w2": (k1, h, d), "b2": (d,),
                    "ln_g": (d,), "ln_b": (d,)}[leaf]
        f, k = cfg.vp_filter_size, cfg.vp_kernel_size
        return {"conv1_w": (k, d, f), "conv1_b": (f,),
                "conv2_w": (k, f, f), "conv2_b": (f,),
                "ln1_g": (f,), "ln1_b": (f,), "ln2_g": (f,), "ln2_b": (f,),
                "lin_w": (f, 1), "lin_b": (1,)}[leaf]

    if section == "decoder":
        b = cfg.bottleneck_dim
        blk = path[1]
        if blk.startswith("encode"):
            ci, co = ((d, b), (b, b))[int(blk[-1])]
            return {"conv1_w": (3, ci, ci), "conv1_b": (ci,),
                    "conv2_w": (3, ci, co), "conv2_b": (co,),
                    "norm1_g": (ci,), "norm1_b": (ci,),
                    "norm2_g": (ci,), "norm2_b": (ci,),
                    "conv1x1_w": (1, ci, co)}[leaf]
        if blk == "asr_res":
            r = cfg.residual_dim
            return {"conv_w": (1, d, r), "conv_b": (r,),
                    "norm_g": (r,), "norm_b": (r,)}[leaf]
        if blk.startswith("decode"):
            ci, co = decoder_block_dims(cfg)[int(blk[-1])]
            s = cfg.style_dim
            return {"fc1_w": (s, 2 * ci), "fc1_b": (2 * ci,),
                    "fc2_w": (s, 2 * co), "fc2_b": (2 * co,),
                    "conv1_w": (3, ci, co), "conv1_b": (co,),
                    "conv2_w": (3, co, co), "conv2_b": (co,),
                    "conv1x1_w": (1, ci, co)}[leaf]
        if blk == "to_out":
            return {"conv_w": (1, d, cfg.num_mels), "conv_b": (cfg.num_mels,)}[leaf]

    if section == "vocoder":
        c = cfg.hifigan_channels
        if path[1] in ("mean", "scale"):
            return (cfg.num_mels,)
        if path[1] == "input_conv_w":
            return (cfg.hifigan_kernel_size, cfg.num_mels, c)
        if path[1] == "input_conv_b":
            return (c,)
        if path[1] == "output_conv_w":
            c_last = c // (2 ** len(cfg.upsample_scales))
            return (cfg.hifigan_kernel_size, c_last, 1)
        if path[1] == "output_conv_b":
            return (1,)
        if path[1] == "upsamples":
            i = path[2]
            ci, co = vocoder_stage_channels(cfg)[i]
            if leaf == "w":
                return (cfg.upsample_kernel_sizes[i], ci, co)
            return (co,)
        if path[1] == "blocks":
            bidx = path[2]
            stage = bidx // cfg.num_resblocks
            co = vocoder_stage_channels(cfg)[stage][1]
            k = cfg.resblock_kernels[bidx % cfg.num_resblocks]
            if leaf == "w":
                return (k, co, co)
            return (co,)

    raise KeyError(f"unknown param path {path}")
