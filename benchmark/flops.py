"""The yardstick's arithmetic: the chip's peaks, and the operations and bytes
of an MRF stage call and of one request.

Operations count two per multiply-add of every convolution, linear layer
and attention product; element-wise work (biases, activations, norms) is
not counted.  Bytes count each input byte read once and each output byte
written once (activations and weights), whatever the kernel reads again.
"""

from __future__ import annotations

from numbers import Integral
from typing import Optional, Sequence, Union

from benchmark.reference.geometry import resblock_kernel_sizes

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).  float32 is
# served through 3xTF32 products (three TF32 tensor-core products each), so
# its peak is the TF32 rate over three: no f32-exact kernel can pass it.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def mrf_stage(B: int, L_in: int, C_in: int, L_out: int, C: int,
              dilation_sets: Sequence[Sequence[int]], kernel_size: Union[int, Sequence[int]],
              up_k: Optional[int], up_stride: Optional[int], elem: int):
    """(operations, bytes) of one MRF stage call: the optional transposed-conv
    upsample (C_in -> C, kernel up_k, stride up_stride; each output row
    takes up_k / up_stride taps), then len(dilation_sets) resblocks of two
    C -> C convs per dilation, on B x L_out rows.  `kernel_size` is every
    resblock's taps, or a sequence of each resblock's, one per dilation set."""
    rows = B * L_out
    ops = 0.0
    w = 0
    if up_k is not None:
        ops += 2.0 * rows * C * C_in * up_k / up_stride
        w += C * C_in * up_k + C
    if isinstance(kernel_size, Integral):
        kernel_size = [kernel_size] * len(dilation_sets)
    if len(kernel_size) != len(dilation_sets):
        raise ValueError(f"{len(kernel_size)} kernel sizes for {len(dilation_sets)} resblocks")
    for dils, k in zip(dilation_sets, kernel_size):
        n_convs = 2 * len(dils)
        ops += n_convs * 2.0 * rows * C * C * k
        w += n_convs * (C * C * k + C)
    nbytes = elem * (B * L_in * C_in + rows * C + w)
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take: max(operations / peak, bytes /
    bandwidth)."""
    return max(ops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)


def front_ops(m: dict) -> float:
    """Operations of the front at its fixed shapes: the encoder and the
    variance adaptor at max_n_phonemes, the decoder at max_seq_len (its
    instance norms reduce over the padded length, so the model is defined
    there)."""
    d = m["emb_dim"] + m["punct_emb_dim"]
    P, T = m["max_n_phonemes"], m["max_seq_len"]
    k0, k1 = m["conv_kernel_size"]
    F_, f, vk = m["conv_filter_size"], m["vp_filter_size"], m["vp_kernel_size"]
    enc = m["encoder_layer"] * (4 * 2 * P * d * d + 2 * 2 * P * P * d
                                + 2 * P * d * F_ * k0 + 2 * P * F_ * d * k1)
    var = 3 * (2 * P * d * f * vk + 2 * P * f * f * vk + 2 * P * f)
    b, r = 2 * d, m["residual_dim"]
    dec = 2 * T * d * d * 3 + 2 * T * d * b * 3 + 2 * T * d * b      # encode.0
    dec += 2 * (2 * T * b * b * 3)                                     # encode.1
    dec += 2 * T * d * r                                               # asr_res
    for ci, co in [(b + r, b), (b + r, b), (b + r, d), (d, d), (d, d)]:
        dec += 2 * d * 2 * ci + 2 * d * 2 * co                         # AdaIN fcs
        dec += 2 * T * ci * co * 3 + 2 * T * co * co * 3
        if ci != co:
            dec += 2 * T * ci * co
    dec += 2 * T * d * m["num_mels"]
    return float(enc + var + dec)


def vocoder_ops(m: dict, frames: int) -> float:
    """Operations of the vocoder over `frames` mel frames."""
    c = m["hifigan_channels"]
    k = m["hifigan_kernel_size"]
    ops = 2.0 * frames * m["num_mels"] * c * k
    L = frames
    for i, (s, uk) in enumerate(zip(m["upsample_scales"], m["upsample_kernel_sizes"])):
        L *= s
        c_in, c_out = c >> i, c >> (i + 1)
        ops += mrf_stage(1, L // s, c_in, L, c_out, m["resblock_dilations"][:m["num_resblocks"]],
                         resblock_kernel_sizes(m), uk, s, 0)[0]
    ops += 2.0 * L * (c >> len(m["upsample_scales"])) * k
    return ops


def request_ops(m: dict, mel_len: int) -> float:
    """The model's operations for one utterance of mel_len frames: the front
    at its fixed shape, the vocoder at the utterance's own length (what the
    program pads beyond it is not useful work)."""
    return front_ops(m) + vocoder_ops(m, mel_len)
