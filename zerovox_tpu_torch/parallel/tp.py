"""The tensor-parallel forward: the front, and the vocoder's channel-sharded
fallback, over the model-axis devices of one data row of a mesh.

GSPMD partitions the JAX package's programs and inserts the collectives;
here they are written out, in one process that drives every device:

* a column-parallel product (a weight split on its output channels) runs
  on each device on a copy of the replicated input and leaves its slice of
  the output channels there;
* a row-parallel product (split on its input channels) takes each device's
  slice, and the partial sums are added on the row's first device (the
  lead) in device order, accumulated in f32 (f64 for a float64 tree) and
  rounded once to the activation dtype, then the replicated bias is added:
  the port's product rule (ops/conv.py) with the sum split in parts;
* replicated work (embeddings, layer norms, residuals, the length
  regulator) runs once, on the lead, and its result is copied to the other
  devices where a column-parallel product needs it, so every device reads
  the same bits.

Attention heads split with the q/k/v columns.  Where a device holds part of
a head (2 heads over 4 devices), each device computes its part of that
head's scores and the parts are summed before the softmax, which runs on
the lead; each device then applies the probabilities to its columns of v,
and the out-projection is row-parallel.  A replicated per-channel vector
that meets a column-sharded activation (a norm's affine after conv1, the
decoder's AdaIN scale and shift from the style) is cut to each device's
channels; a layer norm after a column-parallel product gathers the
channels first.

A tree for this module is a view of one data row (`tp_view`): a split leaf
is a `Shards` of the devices' pieces, a replicated leaf the lead's copy.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import ZeroVoxConfig
from ..models import fs2_encoder, hifigan, styletts_decoder
from ..ops import (conv1d, conv_transpose1d, durations_from_log, instance_norm, layer_norm,
                   leaky_relu, length_regulate, linear, matmul, scalar_as)


class Shards(NamedTuple):
    """A leaf split over the model-axis devices of one data row."""
    parts: Tuple[torch.Tensor, ...]     # device k's piece, on device k
    axis: int                           # the split axis

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def to(self, dtype: torch.dtype) -> "Shards":
        """Each piece in `dtype`, on its device."""
        return Shards(tuple(p.to(dtype) for p in self.parts), self.axis)


def tp_view(trees: Sequence[dict], specs) -> dict:
    """One data row's per-device trees (sharding.shard_params, model order)
    as one tree: Shards where a spec splits the leaf, else device 0's copy."""
    def walk(nodes, spec):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes], spec[k]) for k in nodes[0]}
        if isinstance(nodes[0], list):
            return [walk([n[i] for n in nodes], spec[i]) for i in range(len(nodes[0]))]
        return nodes[0] if spec is None else Shards(tuple(nodes), spec)

    return walk(list(trees), specs)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _reduce(parts: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """Sum of the parts on the lead, in device order."""
    acc = parts[0].to(lead)
    for p in parts[1:]:
        acc = acc + p.to(lead)
    return acc


def _gather(parts: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The parts' channels side by side on the lead (exact)."""
    return torch.cat([p.to(lead) for p in parts], dim=-1)


def _split_like(v: torch.Tensor, w: Shards) -> List[torch.Tensor]:
    """A replicated per-channel vector (..., C) cut to each device's output
    channels of the column-parallel weight w, on that device."""
    sizes = [p.shape[w.axis] for p in w.parts]
    return [s.to(p.device) for s, p in zip(v.split(sizes, dim=-1), w.parts)]


def _col(fn, x: torch.Tensor, w: Shards, b) -> List[torch.Tensor]:
    """Column-parallel fn(x, w, b): each device's output channels, there."""
    bs = b.parts if isinstance(b, Shards) else (None,) * len(w.parts)
    return [fn(x.to(wk.device), wk, bk) for wk, bk in zip(w.parts, bs)]


def _row(fn, xs: Sequence[torch.Tensor], w: Shards, b: Optional[torch.Tensor],
         lead: torch.device) -> torch.Tensor:
    """Row-parallel fn(x, w) + b on the lead: the partial products of each
    device's input channels (xs[k] is copied to device k where it is not
    there) accumulated in f32 (f64), summed in device order, rounded once,
    then the bias."""
    dtype = xs[0].dtype
    acc = _acc(dtype)
    y = _reduce([fn(x.to(wk.device, acc), wk.to(acc), None) for x, wk in zip(xs, w.parts)],
                lead)
    y = y.to(dtype)
    return y if b is None else y + b


def _conv(padding: int = 0, dilation: int = 1):
    return lambda x, w, b: conv1d(x, w, b, padding=padding, dilation=dilation)


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

def attention_tp(x: torch.Tensor, p: dict, n_head: int,
                 mask: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """ops.attention.multi_head_attention with q/k/v column-parallel and the
    out-projection row-parallel (module docstring)."""
    B, T, C = x.shape
    d_k = C // n_head
    lead = x.device
    acc = _acc(x.dtype)
    qs = _col(linear, x, p["wq"], p["bq"])
    ks = _col(linear, x, p["wk"], p["bk"])
    vs = _col(linear, x, p["wv"], p["bv"])

    # (device, head, column slice of the device's piece) for every head part
    pieces, lo = [], 0
    for k, q in enumerate(qs):
        hi = lo + q.shape[-1]
        for h in range(lo // d_k, -(-hi // d_k)):
            a, b = max(lo, h * d_k) - lo, min(hi, (h + 1) * d_k) - lo
            pieces.append((k, h, slice(a, b)))
        lo = hi
    scores = torch.stack([
        _reduce([matmul(qs[k][..., s].to(acc), ks[k][..., s].to(acc).transpose(-1, -2))
                 for k, hh, s in pieces if hh == h], lead)
        for h in range(n_head)], dim=1)                         # (B, H, T, T)
    attn = scores * scalar_as(1.0 / math.sqrt(d_k), x.dtype)
    if mask is not None:
        attn = attn.masked_fill(~mask[:, None, None, :], -1e9)
    attn = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    attn = (attn / attn.sum(dim=-1, keepdim=True)).to(x.dtype)

    outs = []
    for k, v in enumerate(vs):
        a_k = attn.to(v.device)
        outs.append(torch.cat([matmul(a_k[:, h], v[..., s])
                               for kk, h, s in pieces if kk == k], dim=-1))
    out = _row(linear, outs, p["wo"], p["bo"], lead)
    return layer_norm(out + x, p["ln_g"], p["ln_b"], eps=eps)


def fft_block_tp(x: torch.Tensor, p: dict, cfg: ZeroVoxConfig,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fs2_encoder.fft_block: attention_tp, then the conv FFN with w1
    column-parallel and w2 row-parallel."""
    x = attention_tp(x, p["attn"], cfg.encoder_head, mask=mask, eps=cfg.layer_norm_eps)
    f = p["ffn"]
    k0, k1 = cfg.conv_kernel_size
    hs = [torch.relu(h) for h in _col(_conv((k0 - 1) // 2), x, f["w1"], f["b1"])]
    h = _row(_conv((k1 - 1) // 2), hs, f["w2"], f["b2"], x.device)
    return layer_norm(h + x, f["ln_g"], f["ln_b"], eps=cfg.layer_norm_eps)


def variance_predictor_tp(x: torch.Tensor, p: dict, cfg: ZeroVoxConfig) -> torch.Tensor:
    """fs2_encoder.variance_predictor: conv1 column-parallel, its channels
    gathered for the layer norm, conv2 row-parallel."""
    pad = (cfg.vp_kernel_size - 1) // 2
    eps = cfg.layer_norm_eps
    h = _gather([torch.relu(h) for h in _col(_conv(pad), x, p["conv1_w"], p["conv1_b"])],
                x.device)
    h = layer_norm(h, p["ln1_g"], p["ln1_b"], eps=eps)
    sizes = [w.shape[1] for w in p["conv2_w"].parts]
    h = _row(_conv(pad), h.split(sizes, dim=-1), p["conv2_w"], p["conv2_b"], x.device)
    h = layer_norm(torch.relu(h), p["ln2_g"], p["ln2_b"], eps=eps)
    return linear(h, p["lin_w"], p["lin_b"])[..., 0]


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------

def res_blk1d_tp(x: torch.Tensor, p: dict, cfg: ZeroVoxConfig) -> torch.Tensor:
    """styletts_decoder.res_blk1d with conv1 column-parallel (norm2 acts per
    channel on its output) and conv2 row-parallel."""
    eps = cfg.instance_norm_eps
    shortcut = conv1d(x, p["conv1x1_w"]) if "conv1x1_w" in p else x
    h = leaky_relu(instance_norm(x, p["norm1_g"], p["norm1_b"], eps=eps), 0.2)
    hs = _col(_conv(1), h, p["conv1_w"], p["conv1_b"])
    gs, bs = _split_like(p["norm2_g"], p["conv1_w"]), _split_like(p["norm2_b"], p["conv1_w"])
    hs = [leaky_relu(instance_norm(h, g, b, eps=eps), 0.2) for h, g, b in zip(hs, gs, bs)]
    h = _row(_conv(1), hs, p["conv2_w"], p["conv2_b"], x.device)
    return (h + shortcut) * scalar_as(styletts_decoder._INV_SQRT2, h.dtype)


def adain_res_blk1d_tp(x: torch.Tensor, style: torch.Tensor, p: dict,
                       cfg: ZeroVoxConfig) -> torch.Tensor:
    """styletts_decoder.adain_res_blk1d with conv1 column-parallel (the
    second AdaIN's scale and shift cut to its channels) and conv2
    row-parallel."""
    eps = cfg.instance_norm_eps
    h = leaky_relu(styletts_decoder.adain(x, style, p["fc1_w"], p["fc1_b"], eps), 0.2)
    hs = _col(_conv(1), h, p["conv1_w"], p["conv1_b"])
    gb = linear(style, p["fc2_w"], p["fc2_b"])                   # (B, 2C)
    c = gb.shape[-1] // 2
    gammas, betas = _split_like(gb[..., :c], p["conv1_w"]), _split_like(gb[..., c:], p["conv1_w"])
    hs = [leaky_relu((1.0 + g)[:, None, :] * instance_norm(h, eps=eps) + b[:, None, :], 0.2)
          for h, g, b in zip(hs, gammas, betas)]
    h = _row(_conv(1), hs, p["conv2_w"], p["conv2_b"], x.device)
    shortcut = conv1d(x, p["conv1x1_w"]) if "conv1x1_w" in p else x
    return (h + shortcut) * scalar_as(styletts_decoder._INV_SQRT2, h.dtype)


def encode_tp(view: dict, cfg: ZeroVoxConfig, src_seq: torch.Tensor, puncts: torch.Tensor,
              style_embed: torch.Tensor, num_phonemes: Optional[torch.Tensor]):
    """fs2_encoder.encode over one data row, channel-sharded: (features,
    log_duration) on the lead, where the inputs lie."""
    mask = None
    if cfg.use_attention_mask and num_phonemes is not None:
        mask = fs2_encoder.phoneme_mask(num_phonemes, src_seq.shape[-1])
    return fs2_encoder.encode(view, cfg, src_seq, puncts, style_embed, phoneme_mask=mask,
                              fft=fft_block_tp, predictor=variance_predictor_tp)


def decode_tp(view: dict, cfg: ZeroVoxConfig, hidden: torch.Tensor,
              style_embed: torch.Tensor) -> torch.Tensor:
    """styletts_decoder.decode over one data row, channel-sharded: the mel
    on the lead."""
    return styletts_decoder.decode(view, cfg, hidden, style_embed, res_blk=res_blk1d_tp,
                                   adain_blk=adain_res_blk1d_tp)


def front_tp(view: dict, cfg: ZeroVoxConfig, src_seq: torch.Tensor, puncts: torch.Tensor,
             style_embed: torch.Tensor, num_phonemes: Optional[torch.Tensor]):
    """models.pipeline.front over one data row: encode_tp, the length
    regulator on the predicted durations (on the lead), decode_tp.  The
    inputs lie on the lead; returns (mel, mel_len, log_duration) there.
    Training expands with its target durations instead, between the same
    two halves."""
    features, log_dur = encode_tp(view, cfg, src_seq, puncts, style_embed, num_phonemes)
    durations = durations_from_log(log_dur, cfg.max_seq_len)
    hidden, mel_len = length_regulate(features, durations, cfg.max_seq_len,
                                      num_phonemes=num_phonemes)
    return decode_tp(view, cfg, hidden, style_embed), mel_len, log_dur


# --------------------------------------------------------------------------
# the channel-sharded vocoder (the plain version: the kernel is not split)
# --------------------------------------------------------------------------

def _split_product(fn):
    """fn (ops.conv1d's or conv_transpose1d's signature) with the weight
    split (Shards) or not: a split weight's output channels are computed on
    each device and gathered on the lead (x's device) before the next
    product; a replicated bias is added after the gather."""
    def product(x: torch.Tensor, w, b=None, **kw) -> torch.Tensor:
        if not isinstance(w, Shards):
            return fn(x, w, b, **kw)
        y = _gather(_col(lambda x_, w_, b_: fn(x_, w_, b_, **kw), x, w,
                         b if isinstance(b, Shards) else None), x.device)
        return y if b is None or isinstance(b, Shards) else y + b
    return product


def vocode_tp(view: dict, cfg: ZeroVoxConfig, mel: torch.Tensor) -> torch.Tensor:
    """hifigan.vocode with the wide convs split on their output channels
    (sharding._spec_for), every MRF stage through the kernel's plain
    version, on the lead."""
    return hifigan.vocode(view, cfg, mel, conv=_split_product(conv1d),
                          conv_transpose=_split_product(conv_transpose1d))
