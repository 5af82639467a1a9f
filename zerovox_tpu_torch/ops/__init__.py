"""Tensor ops of the port: plain PyTorch, plus the hand-written CUDA kernel
of the vocoder's MRF stage under ops.cuda."""

from .attention import multi_head_attention
from .conv import conv1d, conv_transpose1d, linear, matmul, transpose_out_len
from .length_regulator import durations_from_log, length_regulate
from .misc import bucketize, leaky_relu, scalar_as, sinusoid_encoding_table
from .norm import instance_norm, layer_norm

__all__ = [
    "multi_head_attention", "conv1d", "conv_transpose1d", "linear", "matmul",
    "transpose_out_len", "durations_from_log", "length_regulate",
    "bucketize", "leaky_relu", "scalar_as", "sinusoid_encoding_table",
    "instance_norm", "layer_norm",
]
