"""The port's ops against the COMPILED vendored ggml runtime.

The port's counterpart of tests/test_ggml_diff.py, with its tolerances:
zerovox_tpu_torch/refharness/harness.c, built against the reference's ggml
(the tree at $ZEROVOX_REF) by refharness/build.py::get_harness, runs the
real ggml CPU kernels, and each test holds the port's op (on the CPU; the
convolutions under ops.conv.f16_staging) to them.

Reference code under test:
  ggml_norm      ggml/src/ggml-cpu/ggml-cpu.c:6880  (layer/instance norm)
  ggml_soft_max  ggml/src/ggml-cpu/ggml-cpu.c       (attention softmax)
  ggml_mul_mat   ggml/src/ggml.c:2699               (every linear)
  ggml_conv_1d   ggml/src/ggml.c:3776               (forced-f16 im2col conv)
  zero-stuff ConvTranspose composition  src/hifigan.cpp:22-71

Every test skips where the harness is unavailable (no reference tree, or
no cmake / ninja / C compiler): the reference tree is not in the
repository yet.
"""

import ctypes

import numpy as np
import pytest
import torch

from zerovox_tpu_torch.io import gguf
from zerovox_tpu_torch.ops import conv1d, conv_transpose1d, instance_norm, layer_norm, linear
from zerovox_tpu_torch.ops.conv import f16_staging
from zerovox_tpu_torch.refharness.build import get_harness


@pytest.fixture(scope="module")
def lib():
    harness, reason = get_harness()
    if harness is None:
        pytest.skip(f"ggml harness unavailable: {reason}")
    return harness


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _rng():
    return np.random.default_rng(20260817)


def test_norm_matches_ggml(lib):
    """layer_norm (no affine) == ggml_norm over the innermost axis."""
    x = _rng().normal(size=(37, 528)).astype(np.float32) * 3.0
    out = np.empty_like(x)
    assert lib.zv_ggml_norm(_fp(x), x.shape[1], x.shape[0], ctypes.c_float(1e-5), _fp(out)) == 0
    np.testing.assert_allclose(layer_norm(torch.from_numpy(x), eps=1e-5).numpy(), out,
                               atol=2e-6, rtol=1e-5)


def test_instance_norm_axis_matches_ggml(lib):
    """The reference feeds (C, T) tensors to ggml_norm for an InstanceNorm
    over TIME (stylettsdec.cpp:94-98): the channels-last instance_norm must
    equal ggml_norm on the transposed layout."""
    C, T = 64, 115
    x_ct = _rng().normal(size=(C, T)).astype(np.float32)
    out = np.empty_like(x_ct)
    assert lib.zv_ggml_norm(_fp(x_ct), T, C, ctypes.c_float(1e-5), _fp(out)) == 0
    ours = instance_norm(torch.from_numpy(x_ct.T.copy())[None], eps=1e-5)[0].numpy()
    np.testing.assert_allclose(ours, out.T, atol=2e-6, rtol=1e-5)


def test_soft_max_matches_ggml(lib):
    """The attention's softmax == ggml_soft_max, with the -1e9 masking value."""
    x = _rng().normal(size=(24, 96)).astype(np.float32) * 4.0
    x[5, 10:] = -1e9
    out = np.empty_like(x)
    assert lib.zv_ggml_soft_max(_fp(x), x.shape[1], x.shape[0], _fp(out)) == 0
    np.testing.assert_allclose(torch.softmax(torch.from_numpy(x), -1).numpy(), out,
                               atol=1e-6, rtol=1e-5)


def test_mul_mat_f32_matches_ggml(lib):
    """x @ w.T (the port's (out, in) weights) == ggml_mul_mat(a=w, b=x)."""
    rng = _rng()
    m, k, n = 48, 256, 33
    w = (rng.normal(size=(m, k)) * 0.2).astype(np.float32)
    x = rng.normal(size=(n, k)).astype(np.float32)
    out = np.empty((n, m), np.float32)
    assert lib.zv_ggml_mul_mat(_fp(w), k, m, 0, _fp(x), n, _fp(out)) == 0
    np.testing.assert_allclose(linear(torch.from_numpy(x), torch.from_numpy(w)).numpy(), out,
                               atol=1e-5, rtol=1e-5)


def test_mul_mat_f16_weights_matches_ggml(lib):
    """f16-stored weights: ggml's f16 vec_dot against the port's widened f32
    dot; only the summation order differs."""
    rng = _rng()
    m, k, n = 64, 192, 17
    w = (rng.normal(size=(m, k)) * 0.2).astype(np.float32)
    x = rng.normal(size=(n, k)).astype(np.float32)
    out = np.empty((n, m), np.float32)
    assert lib.zv_ggml_mul_mat(_fp(w), k, m, 1, _fp(x), n, _fp(out)) == 0
    w16 = torch.from_numpy(w).to(torch.float16).to(torch.float32)
    scale = np.abs(out).max()
    np.testing.assert_allclose(linear(torch.from_numpy(x), w16).numpy(), out,
                               atol=2e-3 * scale, rtol=2e-3)


@pytest.mark.parametrize("K,Cin,Cout,T,s,p,d", [
    (7, 80, 96, 50, 1, 3, 1),     # hifigan input conv geometry
    (3, 32, 32, 40, 1, 3, 3),     # dilated resblock conv
    (9, 24, 16, 61, 1, 4, 1),     # fs2 encoder conv (k=9)
    (3, 16, 24, 33, 2, 1, 1),     # strided
])
def test_conv1d_matches_ggml(lib, K, Cin, Cout, T, s, p, d):
    """conv1d under f16_staging == ggml_conv_1d with f16 weights and its
    forced-f16 im2col: exact f32 products of f16 operands on both sides."""
    rng = _rng()
    w = (rng.normal(size=(Cout, Cin, K)) * 0.3).astype(np.float32)
    x = rng.normal(size=(Cin, T)).astype(np.float32)
    T_out = lib.zv_ggml_conv_out_len(T, K, s, p, d)
    out = np.empty((Cout, T_out), np.float32)
    assert lib.zv_ggml_conv_1d(_fp(w), K, Cin, Cout, 1, _fp(x), T, s, p, d, _fp(out)) == 0
    with f16_staging():
        ours = conv1d(torch.from_numpy(x.T.copy())[None], torch.from_numpy(w), stride=s,
                      padding=p, dilation=d)[0].numpy().T
    scale = max(np.abs(out).max(), 1e-3)
    np.testing.assert_allclose(ours, out, atol=1.5e-3 * scale, rtol=2e-3)


@pytest.mark.parametrize("K,Cin,Cout,T,s,p,op", [
    (16, 48, 24, 30, 8, 4, 0),    # standard K == 2s upsample geometry
    (10, 16, 8, 22, 5, 3, 1),     # odd stride (p = s//2 + s%2, op = s%2)
])
def test_conv_transpose_matches_ggml_composition(lib, K, Cin, Cout, T, s, p, op):
    """The port's ConvTranspose1d on the flipped export kernel == the
    reference's zero-stuff view composition (hifigan.cpp:22-71) run through
    real ggml nodes."""
    rng = _rng()
    wf = (rng.normal(size=(Cout, Cin, K)) * 0.3).astype(np.float32)
    x = rng.normal(size=(Cin, T)).astype(np.float32)
    out = np.empty((Cout, (T - 1) * s + K - 2 * p + op), np.float32)
    assert lib.zv_ggml_conv_transpose_1d_ref(_fp(wf), K, Cin, Cout, 1, _fp(x), T, s, p, op,
                                             _fp(out)) == 0
    with f16_staging():
        ours = conv_transpose1d(torch.from_numpy(x.T.copy())[None], torch.from_numpy(wf),
                                stride=s, padding=p, output_padding=op)[0].numpy().T
    scale = max(np.abs(out).max(), 1e-3)
    np.testing.assert_allclose(ours, out, atol=1.5e-3 * scale, rtol=2e-3)


@pytest.mark.parametrize("gt", sorted(gguf._DEQUANTIZERS, key=int), ids=lambda t: t.name)
def test_dequantize_matches_ggml(lib, gt):
    """Every dequantizer the port's GGUF reader advertises == ggml's to_float
    on bytes the real ggml quantizers wrote."""
    nrows, n_per_row = 5, 512
    n = nrows * n_per_row
    blk, bpb = gguf._TYPE_TRAITS[gt]
    nbytes = n // blk * bpb
    x = (_rng().normal(size=(nrows, n_per_row)) * 2.5).astype(np.float32)
    raw = np.zeros(nbytes, np.uint8)
    if gt == gguf.GGMLType.Q8_K:
        # the matmul path's intermediate: only quantize_row_q8_K produces it
        row_b = nbytes // nrows
        for r in range(nrows):
            assert lib.zv_ggml_quantize_row(int(gt), _fp(x[r]), _u8(raw[r * row_b:]),
                                            n_per_row) == 0
    else:
        assert lib.zv_ggml_quantize(int(gt), _fp(x), _u8(raw), nrows, n_per_row) == nbytes
    ref = np.empty(n, np.float32)
    assert lib.zv_ggml_dequantize(int(gt), _u8(raw), _fp(ref), n) == 0
    np.testing.assert_allclose(gguf._DEQUANTIZERS[gt](raw, n), ref, atol=1e-6, rtol=1e-6,
                               err_msg=gt.name)


def test_kquant_container_roundtrip(lib, tmp_path):
    """ggml-quantized Q4_K bytes written through the port's GGUFWriter come
    back from its GGUFReader as ggml's own dequantize_row_q4_K says."""
    shape, n = (4, 512), 2048
    x = (_rng().normal(size=shape) * 1.7).astype(np.float32)
    raw = np.zeros(n // 256 * 144, np.uint8)
    assert lib.zv_ggml_quantize(int(gguf.GGMLType.Q4_K), _fp(x), _u8(raw), 4, 512) == raw.size
    ref = np.empty(n, np.float32)
    assert lib.zv_ggml_dequantize(int(gguf.GGMLType.Q4_K), _u8(raw), _fp(ref), n) == 0
    w = gguf.GGUFWriter()
    w.add_tensor_raw("t", raw.tobytes(), shape, gguf.GGMLType.Q4_K)
    path = str(tmp_path / "kq.gguf")
    w.write(path)
    with gguf.GGUFReader(path) as r:
        got = r.get("t")
    np.testing.assert_allclose(got.reshape(-1), ref, atol=1e-6, rtol=1e-6)
