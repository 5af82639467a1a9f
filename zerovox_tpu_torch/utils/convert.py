"""Checkpoint converter: upstream zerovox torch checkpoints -> GGUF.

The port's copy of zerovox_tpu/utils/convert.py (its output files are equal
byte for byte): GGUF files straight from the upstream PyTorch Lightning
checkpoint + HiFi-GAN pickle + stats.h5, with the transforms of the upstream
exporter (zv2gguf.py):

  - tensor-name shortening
  - weight-norm folding w = g * v / ||v||_dim0
  - ConvTranspose kernel flip + in/out permute for _meldec.upsamples.*
  - selective f16 casts of conv / FFN weights
  - sinusoid position-table precompute
  - the 14 uint32 hparams

Operates on numpy arrays on the host; torch tensors are accepted and detached.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np

from ..config import ZeroVoxConfig
from ..io.gguf import GGUFWriter
from ..ops.misc import sinusoid_encoding_table

SHORTNAMES = {
    "_phoneme_encoder": "_pe",
    "_encoder": "_enc",
    "layer_stack": "laystk",
    "weight": "w",
    "_variance_adaptor": "_var_adapt",
    "energy_predictor": "engy_pred",
    "bias": "b",
}

_UPSAMPLE_RE = re.compile(r"^_meldec\.upsamples\.[0-9]+\.1\.w$")
_F16_SUFFIXES = ("pos_ffn.w_1.w", "pos_ffn.w_2.w", "conv.w")


def shorten_tensor_name(long_name: str) -> str:
    s = long_name
    for l, sh in SHORTNAMES.items():
        s = s.replace(l, sh)
    return s


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def fold_weight_norm(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """torch._weight_norm(v, g, dim=0): w = g * v / ||v|| over dims != 0."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g.reshape(norm.shape) * v / norm).astype(v.dtype)


def convert_state_dict(state_dict: Mapping[str, "np.ndarray"],
                       cfg: ZeroVoxConfig,
                       meldec_state_dict: Optional[Mapping] = None,
                       hifigan_stats: Optional[Mapping] = None,
                       ) -> Dict[str, np.ndarray]:
    """Upstream state dict -> {gguf tensor name: array} with all transforms.

    meldec_state_dict: the HiFi-GAN generator weights (grafted under
    _meldec.*, replacing any _meldec.* already present).
    hifigan_stats: {"mean": (num_mels,), "scale": (num_mels,)}.
    """
    sd = {k: _np(v) for k, v in state_dict.items()
          if not k.startswith("_meldec.")}
    if meldec_state_dict is not None:
        for k, v in meldec_state_dict.items():
            sd["_meldec." + k] = _np(v)

    out: Dict[str, np.ndarray] = {}
    if hifigan_stats is not None:
        out["hifigan.mean"] = _np(hifigan_stats["mean"]).astype(np.float32)
        out["hifigan.scale"] = _np(hifigan_stats["scale"]).astype(np.float32)

    for key in sorted(sd.keys()):
        tensor = sd[key]
        if tensor.ndim == 0:
            continue                       # scalars are not exported
        sname = shorten_tensor_name(key)

        if key.endswith("weight_g"):
            continue                       # folded into the matching weight_v
        if key.endswith("weight_v"):
            gname = key.replace(".weight_v", ".weight_g")
            tensor = fold_weight_norm(tensor, sd[gname])
            sname = shorten_tensor_name(key.replace("weight_v", "weight"))
            if _UPSAMPLE_RE.match(sname):
                # flip along kernel dim, swap in/out channels
                tensor = np.ascontiguousarray(
                    tensor[:, :, ::-1].transpose(1, 0, 2))
            tensor = tensor.astype(np.float16)
        elif any(sname.endswith(sfx) for sfx in _F16_SUFFIXES):
            tensor = tensor.astype(np.float16)

        out[sname] = tensor

    out["sinusoid_encoding_table"] = sinusoid_encoding_table(
        cfg.max_seq_len + 1, cfg.d_model)
    return out


def write_gguf(path: str, tensors: Dict[str, np.ndarray], cfg: ZeroVoxConfig,
               include_config_json: bool = True):
    w = GGUFWriter(arch=cfg.GGUF_ARCH)
    for key, val in cfg.to_gguf_kv().items():
        w.add_uint32(key, val)
    if include_config_json:
        w.add_kv(cfg.GGUF_CONFIG_KEY, cfg.to_json())
    for name, arr in tensors.items():
        w.add_tensor(name, arr)
    w.write(path)


def convert_checkpoint(path_out: str, state_dict: Mapping, cfg: ZeroVoxConfig,
                       meldec_state_dict: Optional[Mapping] = None,
                       hifigan_stats: Optional[Mapping] = None):
    """One-call equivalent of running zv2gguf.py."""
    tensors = convert_state_dict(state_dict, cfg, meldec_state_dict,
                                 hifigan_stats)
    write_gguf(path_out, tensors, cfg)


# --------------------------------------------------------------------------
# CLI: the runnable zv2gguf replacement
# --------------------------------------------------------------------------

def config_from_model_yaml(cfg_dict: dict) -> ZeroVoxConfig:
    """Map the upstream modelcfg.yaml structure onto ZeroVoxConfig (the
    keys zv2gguf.py reads).

    The vocoder/decoder architecture constants the reference C++ hardcodes
    (upsample scales {5,5,4,3}, resblock dilations, residual_dim) default
    to those values; a non-standard
    geometry may override them via an optional `hifigan:` yaml section
    (upsample_scales / upsample_kernel_sizes / channels / num_resblocks /
    resblock_dilations / residual_dim)."""
    m = cfg_dict["model"]
    enc, dec, audio = m["encoder"], m["decoder"], cfg_dict["audio"]
    extra = {}
    h = cfg_dict.get("hifigan", {})
    for yaml_key, field in (("upsample_scales", "upsample_scales"),
                            ("upsample_kernel_sizes", "upsample_kernel_sizes"),
                            ("channels", "hifigan_channels"),
                            ("num_resblocks", "num_resblocks"),
                            ("residual_dim", "residual_dim")):
        if yaml_key in h:
            v = h[yaml_key]
            extra[field] = tuple(v) if isinstance(v, (list, tuple)) else int(v)
    if "resblock_dilations" in h:
        extra["resblock_dilations"] = tuple(
            tuple(d) for d in h["resblock_dilations"])
    # text-front-end sizes are compile-time constants in the reference
    # (NUM_PHONEMES/NUM_PUNCTS/MAX_N_PHONEMES);
    # honor them if the yaml carries them, default to the reference's
    for k in ("num_phonemes", "num_puncts", "max_n_phonemes"):
        if k in m:
            extra[k] = int(m[k])
    return ZeroVoxConfig(
        **extra,
        max_seq_len=int(m["max_seq_len"]),
        emb_dim=int(m["emb_dim"]),
        punct_emb_dim=int(m["punct_emb_dim"]),
        encoder_layer=int(enc["fs2_layer"]),
        encoder_head=int(enc["fs2_head"]),
        vp_filter_size=int(enc["vp_filter_size"]),
        vp_kernel_size=int(enc["vp_kernel_size"]),
        ve_n_bins=int(enc["ve_n_bins"]),
        conv_filter_size=int(dec["conv_filter_size"]),
        conv_kernel_size=(int(dec["conv_kernel_size"][0]),
                          int(dec["conv_kernel_size"][1])),
        sampling_rate=int(audio["sampling_rate"]),
        num_mels=int(audio["num_mels"]),
        hop_size=int(audio["hop_size"]),
    )


def main(argv=None) -> int:
    """`python -m zerovox_tpu_torch.utils.convert --model-dir D --hifigan-dir H
    --out m.gguf`: load the upstream Lightning checkpoint (+ modelcfg.yaml),
    graft the HiFi-GAN generator weights and mel stats, and write the GGUF
    that this package, the JAX package and the reference binary load."""
    import argparse
    import glob
    import os
    import sys

    ap = argparse.ArgumentParser(
        prog="zerovox_tpu_torch.utils.convert",
        description="upstream zerovox checkpoint -> GGUF (zv2gguf)")
    ap.add_argument("--model-dir",
                    help="upstream model dir (modelcfg.yaml + checkpoints/*.ckpt)")
    ap.add_argument("--ckpt", help="explicit .ckpt path (else newest in "
                                   "<model-dir>/checkpoints/)")
    ap.add_argument("--model-cfg", help="explicit modelcfg.yaml path")
    ap.add_argument("--hifigan-dir",
                    help="HiFi-GAN dir (checkpoint.pkl + stats.h5)")
    ap.add_argument("--out", required=True, help="output GGUF path")
    args = ap.parse_args(argv)

    try:
        import torch
        import yaml
    except ImportError as e:
        ap.error(f"converter needs torch + pyyaml: {e}")

    cfg_path = args.model_cfg or (args.model_dir and
                                  os.path.join(args.model_dir, "modelcfg.yaml"))
    if not cfg_path or not os.path.exists(cfg_path):
        ap.error("need --model-cfg or --model-dir containing modelcfg.yaml")
    with open(cfg_path) as f:
        cfg = config_from_model_yaml(yaml.safe_load(f))

    ckpt_path = args.ckpt
    if not ckpt_path:
        cands = glob.glob(os.path.join(args.model_dir or ".",
                                       "checkpoints", "*.ckpt"))
        if not cands:
            ap.error("no .ckpt found; pass --ckpt")
        ckpt_path = max(cands, key=os.path.getctime)   # newest, like zv2gguf
    print(f"loading checkpoint {ckpt_path} ...", file=sys.stderr)
    try:
        checkpoint = torch.load(ckpt_path, map_location="cpu",
                                weights_only=False)
    except (OSError, RuntimeError, EOFError) as e:
        ap.error(f"cannot load checkpoint {ckpt_path}: {e}")
    state_dict = checkpoint["state_dict"] if "state_dict" in checkpoint \
        else checkpoint

    meldec_sd, stats = None, None
    if args.hifigan_dir:
        pkl = os.path.join(args.hifigan_dir, "checkpoint.pkl")
        h5 = os.path.join(args.hifigan_dir, "stats.h5")
        # fail on the FAST missing file before the slow torch.load
        for f in (pkl, h5):
            if not os.path.exists(f):
                ap.error(f"missing {f} (the HiFi-GAN dir needs "
                         "checkpoint.pkl + stats.h5)")
        print(f"loading HiFi-GAN {pkl} ...", file=sys.stderr)
        try:
            hifigan = torch.load(pkl, map_location="cpu", weights_only=False)
            meldec_sd = hifigan["model"]["generator"]
        except (OSError, RuntimeError, EOFError, KeyError) as e:
            ap.error(f"cannot load {pkl}: {e}")
        try:
            import h5py
        except ImportError:
            ap.error("reading stats.h5 needs h5py")
        try:
            with h5py.File(h5, "r") as f:
                stats = {"mean": f["mean"][:], "scale": f["scale"][:]}
        except (OSError, KeyError) as e:
            ap.error(f"cannot read {h5}: {e}")

    convert_checkpoint(args.out, state_dict, cfg,
                       meldec_state_dict=meldec_sd, hifigan_stats=stats)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
