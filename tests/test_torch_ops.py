"""Each op of the port against its JAX twin, at TINY and production widths.

Integer logic (bucketize, durations, length regulator) must match exactly;
norms within atol 2e-6 / rtol 1e-5, the other float ops within atol 1e-5 /
rtol 1e-5 (both sides f32; only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.ops as jops
from zerovox_tpu.ops.conv import conv_transpose1d as j_convT

import zerovox_tpu_torch.ops as tops

F32 = dict(atol=1e-5, rtol=1e-5)
NORM = dict(atol=2e-6, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_bucketize_exact(rng):
    n_bins = 256
    x = rng.uniform(-0.2, 1.2, size=(3, 200)).astype(np.float32)
    # values on the rounding boundaries (k + 0.5) / (n_bins - 1)
    x[0, :50] = ((np.arange(50) + 0.5) / (n_bins - 1)).astype(np.float32)
    got = tops.bucketize(_t(x), n_bins).numpy()
    ref = np.asarray(jops.bucketize(jnp.asarray(x), n_bins))
    np.testing.assert_array_equal(got, ref)


def test_durations_from_log_exact(rng):
    ld = rng.normal(1.0, 1.5, size=(4, 120)).astype(np.float32)
    ld[0, :3] = [100.0, -100.0, np.log(2.5)]          # overflow, underflow, edge
    got = tops.durations_from_log(_t(ld), 1500).numpy()
    ref = np.asarray(jops.durations_from_log(jnp.asarray(ld), 1500))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32


@pytest.mark.parametrize("max_seq_len,use_n", [(64, False), (64, True), (20, True)])
def test_length_regulate_exact(rng, max_seq_len, use_n):
    """Including truncation mid-repeat at max_seq_len (20) and the
    num_phonemes cut."""
    feats = rng.normal(size=(3, 16, 8)).astype(np.float32)
    dur = rng.integers(0, 5, size=(3, 16)).astype(np.int32)
    n = np.asarray([16, 9, 1], np.int32) if use_n else None
    got, got_len = tops.length_regulate(_t(feats), _t(dur), max_seq_len,
                                        None if n is None else _t(n))
    ref, ref_len = jops.length_regulate(jnp.asarray(feats), jnp.asarray(dur),
                                        max_seq_len,
                                        None if n is None else jnp.asarray(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))


@pytest.mark.parametrize("C,T", [(56, 16), (528, 24), (1056, 12)])
def test_norms(rng, C, T):
    x = (rng.normal(size=(2, T, C)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=(C,)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    np.testing.assert_allclose(
        tops.layer_norm(_t(x), _t(g), _t(b)).numpy(),
        np.asarray(jops.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))), **NORM)
    np.testing.assert_allclose(
        tops.instance_norm(_t(x), _t(g), _t(b)).numpy(),
        np.asarray(jops.instance_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))), **NORM)
    np.testing.assert_allclose(tops.instance_norm(_t(x)).numpy(),
                               np.asarray(jops.instance_norm(jnp.asarray(x))), **NORM)


@pytest.mark.parametrize("Cin,Cout,K,pad,dil", [
    (8, 16, 3, 1, 1), (32, 32, 3, 5, 5), (80, 512, 7, 3, 1),
    (528, 256, 3, 1, 1), (1056, 64, 1, 0, 1), (256, 256, 3, 3, 3)])
def test_conv1d(rng, Cin, Cout, K, pad, dil):
    x = rng.normal(size=(2, 40, Cin)).astype(np.float32)
    w = (rng.normal(size=(K, Cin, Cout)) / np.sqrt(K * Cin)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    got = tops.conv1d(_t(x), _t(w.transpose(2, 1, 0)), _t(b), padding=pad,
                      dilation=dil).numpy()
    ref = np.asarray(jops.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                 padding=pad, dilation=dil))
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("s,K,Cin,Cout", [
    (5, 10, 32, 16), (4, 8, 16, 8), (3, 6, 8, 4),         # standard K == 2s
    (5, 11, 32, 16), (5, 12, 32, 16),                     # nonstandard (test_pallas)
    (5, 10, 512, 256), (3, 6, 64, 32)])                   # production widths
def test_conv_transpose1d(rng, s, K, Cin, Cout):
    x = rng.normal(size=(2, 24, Cin)).astype(np.float32)
    w = (rng.normal(size=(K, Cin, Cout)) / np.sqrt(Cin)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    pad, opad = s // 2 + s % 2, s % 2
    got = tops.conv_transpose1d(_t(x), _t(w.transpose(2, 1, 0)), _t(b),
                                stride=s, padding=pad, output_padding=opad).numpy()
    ref = np.asarray(j_convT(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride=s, padding=pad, output_padding=opad))
    assert got.shape == ref.shape == (2, tops.transpose_out_len(24, s, K, pad, opad), Cout)
    np.testing.assert_allclose(got, ref, **F32)


def test_conv_transpose1d_rejects_bad_output_padding():
    with pytest.raises(ValueError):
        tops.conv_transpose1d(torch.zeros(1, 4, 2), torch.zeros(2, 2, 4),
                              stride=2, padding=1, output_padding=2)


def test_convs_run_without_tf32(monkeypatch):
    """cuDNN's TF32 is off inside both convs once the process-wide switch is
    set (device.full_precision_products, called where a CUDA device is
    resolved), and the convs themselves toggle no flag."""
    import torch.nn.functional as F
    from zerovox_tpu_torch.device import full_precision_products
    seen = []
    for name in ("conv1d", "conv_transpose1d"):
        real = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _real=real, **k: (
            seen.append(torch.backends.cudnn.allow_tf32), _real(*a, **k))[1])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", True)
    full_precision_products()
    tops.conv1d(torch.zeros(1, 4, 2), torch.zeros(3, 2, 3), padding=1)
    tops.conv_transpose1d(torch.zeros(1, 4, 2), torch.zeros(3, 2, 4),
                          stride=2, padding=1)
    assert seen == [False, False] and not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_tf32_flag_is_not_raced_between_threads(monkeypatch):
    """Two products on two threads, one inside the other in time: thread A
    enters its product, thread B enters its own after it, A runs to its end
    while B's convolution is still to be issued.  B must then find cuDNN's
    TF32 off.  (A save / clear / restore of the process-wide flag around each
    product fails here: B saves A's False, A restores True under B.)"""
    import threading
    from zerovox_tpu_torch.device import full_precision_products
    from zerovox_tpu_torch.ops.conv import _product
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", True)
    full_precision_products()                 # what resolving a CUDA device does, once
    a_in, a_go, b_in, b_go = (threading.Event() for _ in range(4))
    seen = {}

    def fn_a(x, w, b):
        a_in.set()
        assert a_go.wait(timeout=30)
        return x

    def fn_b(x, w, b):
        b_in.set()
        assert b_go.wait(timeout=30)
        seen["tf32"] = torch.backends.cudnn.allow_tf32      # just before B's conv is issued
        return x

    x, w = torch.zeros(1, 2, 4), torch.zeros(2, 2, 1)
    ta = threading.Thread(target=_product, args=(fn_a, x, w, None))
    tb = threading.Thread(target=_product, args=(fn_b, x, w, None))
    ta.start()
    assert a_in.wait(timeout=30)
    tb.start()
    assert b_in.wait(timeout=30)
    a_go.set()
    ta.join(timeout=30)
    assert not ta.is_alive()
    b_go.set()
    tb.join(timeout=30)
    assert not tb.is_alive()
    assert seen == {"tf32": False}
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("Cin,Cout", [(56, 112), (528, 1056)])
def test_linear(rng, Cin, Cout):
    x = rng.normal(size=(2, 5, Cin)).astype(np.float32)
    w = (rng.normal(size=(Cin, Cout)) / np.sqrt(Cin)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    np.testing.assert_allclose(
        tops.linear(_t(x), _t(w.T), _t(b)).numpy(),
        np.asarray(jops.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))), **F32)


@pytest.mark.parametrize("C,H,masked", [(56, 2, False), (56, 2, True), (528, 2, False)])
def test_multi_head_attention(rng, C, H, masked):
    T = 12
    x = rng.normal(size=(2, T, C)).astype(np.float32)
    pj, pt = {}, {}
    for n in ("q", "k", "v", "o"):
        w = (rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32)
        b = rng.normal(size=(C,)).astype(np.float32) * 0.1
        pj["w" + n], pj["b" + n] = jnp.asarray(w), jnp.asarray(b)
        pt["w" + n], pt["b" + n] = _t(w.T), _t(b)
    g = rng.normal(size=(C,)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    pj["ln_g"], pj["ln_b"], pt["ln_g"], pt["ln_b"] = jnp.asarray(g), jnp.asarray(b), _t(g), _t(b)
    mask = np.arange(T)[None, :] < np.asarray([T, 7])[:, None] if masked else None
    got = tops.multi_head_attention(_t(x), pt, H, mask=None if mask is None else _t(mask))
    ref = jops.multi_head_attention(jnp.asarray(x), pj, H,
                                    mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_leaky_and_sinusoid(rng):
    x = rng.normal(size=(4, 9)).astype(np.float32)
    for s in (0.1, 0.01, 0.2):
        np.testing.assert_array_equal(tops.leaky_relu(_t(x), s).numpy(),
                                      np.asarray(jops.leaky_relu(jnp.asarray(x), s)))
    np.testing.assert_array_equal(tops.sinusoid_encoding_table(65, 56),
                                  jops.sinusoid_encoding_table(65, 56))


# --------------------------------------------------------------------------
# bf16 (the serving dtype): bf16 operands, f32 accumulation, one rounding
# --------------------------------------------------------------------------

BF16_ULP = 2.0 ** -8


def _t16(a):
    return _t(np.asarray(a, np.float32)).to(torch.bfloat16)


def _j16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _close16(got, ref, ulps=2.0):
    """Both sides round the same f32 sums (taken in another order) to bf16:
    equal to `ulps` bf16 ulps of each element plus one at the output's
    scale (a sum near a rounding boundary falls either way; after a bias
    add, twice)."""
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    g, r = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert g.shape == r.shape
    assert np.all(np.abs(g - r) <= BF16_ULP * (ulps * np.abs(r) + np.abs(r).max()))
    assert np.mean(g == r) > 0.9


@pytest.mark.parametrize("dim,fn", [(-1, "layer_norm"), (-2, "instance_norm")])
def test_norm_moments_one_pass_for_bf16(rng, dim, fn):
    """A non-f32 input takes its moments in one pass, E[x^2] - E[x]^2 clamped
    at 0, in f32 (the JAX package's serving rule); an f32 input in two."""
    x = (rng.normal(size=(2, 24, 56)) * 3 + 1).astype(np.float32)
    x16 = _t16(x)
    xf = x16.float()
    n = xf.shape[dim]
    mean = xf.sum(dim, keepdim=True) / n
    var = torch.clamp((xf * xf).sum(dim, keepdim=True) / n - mean * mean, min=0.0)
    want = ((xf - mean) / torch.sqrt(var + 1e-5)).to(torch.bfloat16)
    got = getattr(tops, fn)(x16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 * BF16_ULP * 4)
    _close16(got, getattr(jops, fn)(_j16(x)))
    # a constant input: the one-pass variance cancels to <= 0 and is clamped
    flat = torch.full((1, 16, 8), 3.140625, dtype=torch.bfloat16)
    assert torch.isfinite(getattr(tops, fn)(flat).float()).all()
    # the f32 path is still two-pass: exact zero for a constant
    assert getattr(tops, fn)(flat.float()).abs().max().item() == 0.0


@pytest.mark.parametrize("Cin,Cout,K,pad,dil", [
    (8, 16, 3, 1, 1), (32, 32, 3, 5, 5), (528, 256, 3, 1, 1), (1056, 64, 1, 0, 1)])
def test_conv1d_bf16(rng, Cin, Cout, K, pad, dil):
    x = rng.normal(size=(2, 40, Cin)).astype(np.float32)
    w = (rng.normal(size=(K, Cin, Cout)) / np.sqrt(K * Cin)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    got = tops.conv1d(_t16(x), _t16(w.transpose(2, 1, 0)), _t16(b), padding=pad, dilation=dil)
    _close16(got, jops.conv1d(_j16(x), _j16(w), _j16(b), padding=pad, dilation=dil))


def test_conv_transpose1d_and_linear_bf16(rng):
    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    w = (rng.normal(size=(10, 32, 16)) / np.sqrt(32)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    got = tops.conv_transpose1d(_t16(x), _t16(w.transpose(2, 1, 0)), _t16(b), stride=5,
                                padding=3, output_padding=1)
    _close16(got, j_convT(_j16(x), _j16(w), _j16(b), stride=5, padding=3, output_padding=1))
    wl = (rng.normal(size=(32, 48)) / np.sqrt(32)).astype(np.float32)
    bl = rng.normal(size=(48,)).astype(np.float32)
    _close16(tops.linear(_t16(x), _t16(wl.T), _t16(bl)), jops.linear(_j16(x), _j16(wl), _j16(bl)))
    assert tops.matmul(_t16(x), _t16(wl)).dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_bf16(rng, masked):
    """Scores and softmax in f32, 1/sqrt(d_k) and the probabilities rounded
    to bf16, as the JAX op; the block ends in a layer norm, so errors are
    measured at unit scale: 4 ulps + one at the output's scale."""
    C, H, T = 56, 2, 12
    x = rng.normal(size=(2, T, C)).astype(np.float32)
    pj, pt = {}, {}
    for n in ("q", "k", "v", "o"):
        w = (rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32)
        b = rng.normal(size=(C,)).astype(np.float32) * 0.1
        pj["w" + n], pj["b" + n] = _j16(w), _j16(b)
        pt["w" + n], pt["b" + n] = _t16(w.T), _t16(b)
    g = rng.normal(size=(C,)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    pj["ln_g"], pj["ln_b"], pt["ln_g"], pt["ln_b"] = _j16(g), _j16(b), _t16(g), _t16(b)
    mask = np.arange(T)[None, :] < np.asarray([T, 7])[:, None] if masked else None
    got = tops.multi_head_attention(_t16(x), pt, H, mask=None if mask is None else _t(mask))
    ref = jops.multi_head_attention(_j16(x), pj, H,
                                    mask=None if mask is None else jnp.asarray(mask))
    assert got.dtype == torch.bfloat16
    g_, r_ = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert np.all(np.abs(g_ - r_) <= BF16_ULP * (4 * np.abs(r_) + np.abs(r_).max()))


def test_bf16_scalars_and_reductions(rng, monkeypatch):
    """A scalar that meets a bf16 tensor is rounded to bf16 first (JAX's
    weak typing); the int ops work on f32 casts; reduced-precision bf16
    reductions are off inside a product and restored after it."""
    assert tops.scalar_as(0.2, torch.bfloat16) == 0.2001953125
    assert tops.scalar_as(0.2, torch.float32) == float(np.float32(0.2))
    x = rng.normal(size=(4, 33)).astype(np.float32)
    for s in (0.1, 0.01, 0.2):
        np.testing.assert_array_equal(
            tops.leaky_relu(_t16(x), s).float().numpy(),
            np.asarray(jops.leaky_relu(_j16(x), s).astype(jnp.float32)))
    p = rng.uniform(-0.2, 1.2, size=(3, 50)).astype(np.float32)
    np.testing.assert_array_equal(tops.bucketize(_t16(p), 256).numpy(),
                                  np.asarray(jops.bucketize(_j16(p), 256)))
    ld = rng.normal(1.0, 1.5, size=(2, 40)).astype(np.float32)
    np.testing.assert_array_equal(tops.durations_from_log(_t16(ld), 1500).numpy(),
                                  np.asarray(jops.durations_from_log(_j16(ld), 1500)))
    # f32 accumulation of cuBLAS's bf16 products is a process-wide switch,
    # set once where a CUDA device is resolved, not around each product
    from zerovox_tpu_torch.device import full_precision_products
    mm = torch.backends.cuda.matmul
    monkeypatch.setattr(mm, "allow_bf16_reduced_precision_reduction", True)
    full_precision_products()
    assert not mm.allow_bf16_reduced_precision_reduction
