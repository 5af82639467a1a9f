"""The port's f16 staging (ops.conv.f16_staging, what `--verify` runs) against
the JAX package's (zerovox_tpu/ops/conv.py:29-67), on the CPU.

Tolerances:
  * one conv (every form: k=3 at C <= 64, which JAX runs as an im2col
    matmul; k=3 at C=256; 1x1; the transposed conv): rtol 1e-6 with an atol
    of 1e-6 of the output's scale.  The operands are the same f16 values on
    both sides and every product is exact in f32: only the order of the f32
    sums differs.
  * one MRF stage (the port's mrf_stage_ref against the JAX vocoder's
    folded XLA stage, both staged): per element 2 f16 ulps (2^-10) of its
    magnitude plus one at the output's scale, the gate chip_smoke.py holds
    the kernel's f16-staged mode to.  A chain of 18 staged convs can round
    one operand the other way where the sums' order differs.
  * the three stages: a quarter of the `--verify` band of the matching
    boundary (utils/verify.py: encoder 5e-4 + 1e-3 max|ref|, decoder 5e-3 +
    1e-3 max|ref|, vocoder 2e-3 + 1e-3 max|ref|), the measured maximum
    printed; the decoder half its band.  Staged, the decoder's chain of
    convs and instance norms turns the order of f32 sums into f16 roundings
    that fall the other way: at TINY on N(0, 1) hidden states the JAX
    decoder lies 2.1e-3 - 2.6e-3 from the same staged decoder accumulated in
    float64, and the port 2.0e-3 - 2.5e-3 (0.25 - 0.31 of the band, four
    draws), so no f32 implementation holds a quarter of it against another.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY, ZeroVoxConfig as JConfig
from zerovox_tpu.models import fs2_encoder as j_enc
from zerovox_tpu.models import hifigan as j_voc
from zerovox_tpu.models import styletts_decoder as j_dec
from zerovox_tpu.ops import conv as jconv
from zerovox_tpu.ops.length_regulator import durations_from_log as j_durations
from zerovox_tpu.ops.length_regulator import length_regulate as j_regulate

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
from zerovox_tpu_torch.models import fs2_encoder, hifigan, styletts_decoder
from zerovox_tpu_torch.ops import conv as tconv
from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
from zerovox_tpu_torch.ops.length_regulator import durations_from_log, length_regulate

F16_ULP = 2.0 ** -10


def _pair(jcfg, tcfg, seed=0):
    pj = jparams.init_params(jcfg, seed=seed)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, jcfg), tcfg, device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def tiny():
    return _pair(J_TINY, TINY_CONFIG)


def _close_one_op(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def _within_band(name, got, ref, band, quarter=0.25):
    """max|got - ref| within the fraction `quarter` of the verify band;
    prints both."""
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    tol = quarter * band(ref)
    print(f"{name}: max|diff| {err:.3e}, {quarter} of the band {tol:.3e}")
    assert err <= tol, f"{name}: max|diff| {err:.3e} > {tol:.3e}"


def _encoder_band(ref):
    return 5e-4 + 1e-3 * np.abs(ref).max()


def _decoder_band(ref):
    return 5e-3 + 1e-3 * np.abs(ref).max()


def _vocoder_band(ref):
    return 2e-3 + 1e-3 * np.abs(ref).max()


# --------------------------------------------------------------------------
# one conv, every form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("C,K,dilation", [(48, 3, 3), (256, 3, 1), (256, 1, 1)])
def test_conv1d_staged_matches_jax(rng, C, K, dilation):
    """k=3 at C=48 (JAX's im2col route), k=3 at C=256 (its native conv), 1x1
    (its dot), with biases, at B=2; activations of a few units so that the
    f16 rounding moves them."""
    x = (rng.normal(size=(2, 40, C)) * 3).astype(np.float32)
    w = (rng.normal(size=(K, C, C)) * 0.1).astype(np.float32)          # JAX HIO
    b = rng.normal(size=C).astype(np.float32)
    pad = (K - 1) // 2 * dilation
    with jconv.f16_staging():
        ref = jax.jit(lambda x, w, b: jconv.conv1d(x, w, b, padding=pad, dilation=dilation))(
            x, w, b)
    with tconv.f16_staging():
        got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                           torch.from_numpy(b), padding=pad, dilation=dilation)
    _close_one_op(got.numpy(), ref)


@pytest.mark.parametrize("s,Cin,C", [(5, 64, 32), (3, 256, 128)])
def test_conv_transpose1d_staged_matches_jax(rng, s, Cin, C):
    x = (rng.normal(size=(2, 20, Cin)) * 3).astype(np.float32)
    w = (rng.normal(size=(2 * s, Cin, C)) * 0.1).astype(np.float32)    # JAX flipped HIO
    b = rng.normal(size=C).astype(np.float32)
    kw = dict(stride=s, padding=s // 2 + s % 2, output_padding=s % 2)
    with jconv.f16_staging():
        ref = jax.jit(lambda x, w, b: jconv.conv_transpose1d(x, w, b, **kw))(x, w, b)
    with tconv.f16_staging():
        got = tconv.conv_transpose1d(torch.from_numpy(x),
                                     torch.from_numpy(w.transpose(2, 1, 0).copy()),
                                     torch.from_numpy(b), **kw)
    _close_one_op(got.numpy(), ref)


def test_staging_changes_the_answer(rng):
    """Staged, a conv equals the unstaged conv of the f16-rounded operands
    (bias unrounded) to the last bit, and differs from the unstaged conv;
    linear and matmul stay unstaged; values beyond 65504 become inf."""
    x = torch.from_numpy((rng.normal(size=(1, 30, 32)) * 3).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(32, 32, 3)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=32).astype(np.float32) / 3)
    plain = tconv.conv1d(x, w, b, padding=1)
    with tconv.f16_staging():
        staged = tconv.conv1d(x, w, b, padding=1)
        assert tconv.staging()
        lin = tconv.linear(x, w[:, :, 0], b)
        mm = tconv.matmul(x, w[:, :, 0])
    assert not tconv.staging()
    assert torch.equal(staged, tconv.conv1d(tconv.round_f16(x), tconv.round_f16(w), None,
                                            padding=1) + b)
    rel = ((staged - plain).abs().max() / plain.abs().max()).item()
    assert 1e-5 < rel < 1e-2, rel
    assert torch.equal(lin, tconv.linear(x, w[:, :, 0], b))
    assert torch.equal(mm, tconv.matmul(x, w[:, :, 0]))
    assert torch.isinf(tconv.round_f16(torch.tensor([65520.0, -1e6]))).all()
    assert tconv.round_f16(torch.tensor([65504.0])).item() == 65504.0


def test_staging_keeps_float64(rng):
    """Staged, a float64 conv rounds its operands to the same f16 values as
    a float32 one and sums their products in float64 (the staged chain with
    exact sums, which chip_smoke.py holds the card's float32 orders
    against); its result lies within float32 noise of the float32 staged
    conv and is not that conv's result."""
    x = torch.from_numpy((rng.normal(size=(1, 40, 64)) * 3).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 64, 3)) * 0.1).astype(np.float32))
    with tconv.f16_staging():
        got = tconv.conv1d(x.double(), w.double(), None, padding=1)
        f32 = tconv.conv1d(x, w, None, padding=1)
    assert got.dtype == torch.float64
    assert torch.equal(tconv.round_f16(x.double()), tconv.round_f16(x).double())
    want = tconv.conv1d(tconv.round_f16(x).double(), tconv.round_f16(w).double(), None,
                        padding=1)
    assert torch.equal(got, want)
    rel = ((got - f32.double()).abs().max() / got.abs().max()).item()
    assert 0 < rel < 1e-6, rel


def test_f16_values_are_tf32_values(rng):
    """The premise of the kernel's f16-staged mode: an f16 value held in
    f32 is a TF32 value, so the kernel's split (split_tf32) of a staged
    operand has lo = 0 and one TF32 product is exact; normal, subnormal
    and largest f16 values alike."""
    v = torch.from_numpy(np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-6, 5, size=4096),
        [65504.0, -65504.0, 2.0 ** -24, 2.0 ** -14 * 0.75, 0.0]]).astype(np.float32))
    f16 = tconv.round_f16(v)
    hi, lo = ms.split_tf32(f16)
    assert torch.equal(hi, f16) and torch.equal(lo, torch.zeros_like(lo))
    assert not torch.equal(ms.split_tf32(v)[1], torch.zeros_like(v))


def test_staging_is_per_thread(rng):
    """A staged call on one thread and unstaged calls on another, at the
    same time, each equal their own reference: the flag is a context
    variable, not a process global (the serving daemon's threads)."""
    x = torch.from_numpy((rng.normal(size=(1, 64, 64)) * 3).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 64, 3)) * 0.1).astype(np.float32))
    plain = tconv.conv1d(x, w, padding=1)
    with tconv.f16_staging():
        staged = tconv.conv1d(x, w, padding=1)
    assert not torch.equal(plain, staged)
    barrier = threading.Barrier(2)
    wrong = []

    def run(stage):
        barrier.wait(timeout=30)
        for _ in range(200):
            if stage:
                with tconv.f16_staging():
                    got = tconv.conv1d(x, w, padding=1)
            else:
                got = tconv.conv1d(x, w, padding=1)
            if not torch.equal(got, staged if stage else plain):
                wrong.append(stage)

    threads = [threading.Thread(target=run, args=(s,)) for s in (True, False)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert wrong == []


# --------------------------------------------------------------------------
# the MRF stage
# --------------------------------------------------------------------------

def _jax_stage(x, blocks, dils, k, up_w, up_b, scale, in_leaky, out_leaky):
    """One MRF stage as the JAX vocoder runs it on its folded XLA route
    (zerovox_tpu/models/hifigan.py:236-269), out_leaky applied after."""
    if in_leaky is not None:
        x = j_voc.leaky_relu(x, in_leaky)
    c = jconv.conv_transpose1d(x, up_w, up_b, stride=scale, padding=scale // 2 + scale % 2,
                               output_padding=scale % 2)
    C = c.shape[-1]
    rho = min(128 // C if 128 % C == 0 else 1, 8)
    if c.shape[1] % rho:
        rho = 1
    c = jconv.fold(c, rho) if rho > 1 else c
    acc = None
    for j, blk in enumerate(blocks):
        r = j_voc.residual_block(c, blk, dils[j], k, rho=rho)
        acc = r if acc is None else acc + r
    c = acc * (1.0 / len(blocks))
    c = jconv.unfold(c, rho) if rho > 1 else c
    return c if out_leaky is None else j_voc.leaky_relu(c, out_leaky)


@pytest.mark.parametrize("which,stage,R,in_leaky,out_leaky", [
    ("tiny", 0, 12, 0.1, 0.1),          # C=16: folded at rho 8
    ("prod", 3, 10, None, 0.01)])       # production stage 4, C=32: folded at rho 4
def test_mrf_stage_ref_staged_matches_jax_stage(rng, tiny, which, stage, R, in_leaky,
                                                out_leaky):
    if which == "tiny":
        jcfg, tcfg, (pj, pt) = J_TINY, TINY_CONFIG, tiny
    else:
        jcfg, tcfg = JConfig(max_seq_len=16), ZeroVoxConfig(max_seq_len=16)
        pj, pt = _pair(jcfg, tcfg)
    n = tcfg.num_resblocks
    s = tcfg.upsample_scales[stage]
    jup, tup = pj["vocoder"]["upsamples"][stage], pt["vocoder"]["upsamples"][stage]
    x = (rng.normal(size=(2, R, tup["w"].shape[1])) * 2).astype(np.float32)
    with jconv.f16_staging():
        ref = jax.jit(lambda x: _jax_stage(
            x, pj["vocoder"]["blocks"][stage * n:(stage + 1) * n], jcfg.resblock_dilations,
            jcfg.resblock_kernel_size, jup["w"], jup["b"], s, in_leaky, out_leaky))(x)
    with tconv.f16_staging():
        got = ms.mrf_stage_ref(
            torch.from_numpy(x), pt["vocoder"]["blocks"][stage * n:(stage + 1) * n],
            tcfg.resblock_dilations, tcfg.resblock_kernel_size,
            upsample=dict(w=tup["w"], stride=s, padding=s // 2 + s % 2, output_padding=s % 2),
            in_bias=tup["b"], in_leaky=in_leaky, out_leaky=out_leaky).numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    tol = F16_ULP * (2 * np.abs(ref) + np.abs(ref).max())
    worst = float((np.abs(got - ref) / tol).max())
    print(f"{which} stage {stage + 1}: max|diff| {np.abs(got - ref).max():.3e}, "
          f"{worst:.3f} of the f16 ulp gate")
    assert worst <= 1.0


def test_pack_stage_staged_rounds_the_weights(tiny):
    """Packed under f16_staging, the weights are the f32 pack of
    f16-rounded weights (biases as they are)."""
    _, pt = tiny
    n = TINY_CONFIG.num_resblocks
    blocks = pt["vocoder"]["blocks"][:n]
    up = pt["vocoder"]["upsamples"][0]["w"]
    dils, k = TINY_CONFIG.resblock_dilations, TINY_CONFIG.resblock_kernel_size
    plain = ms.pack_stage(blocks, dils, k, up)
    with tconv.f16_staging():
        staged = ms.pack_stage(blocks, dils, k, up)
    assert staged.staged and not plain.staged
    assert torch.equal(staged.w, tconv.round_f16(plain.w))
    assert torch.equal(staged.w_up, tconv.round_f16(plain.w_up))
    assert torch.equal(staged.b, plain.b) and not torch.equal(staged.w, plain.w)


def test_staged_mode_refusals(tiny):
    """Under f16_staging a bf16 stage raises (no entry point asks for one,
    the kernel has no such mode), and a launch with weights packed outside
    the staging raises before anything is built (a meta tensor stands for
    the card): no silent unstaged kernel."""
    _, pt = tiny
    prod = ZeroVoxConfig()
    from test_torch_mrf import _meta_vocoder
    voc = _meta_vocoder(prod)["vocoder"]
    blocks = voc["blocks"][:prod.num_resblocks]
    dils, k = prod.resblock_dilations, prod.resblock_kernel_size
    x = torch.empty(1, 16, 256, device="meta")
    unstaged = ms.pack_stage(blocks, dils, k)
    with torch.no_grad(), tconv.f16_staging():
        with pytest.raises(ValueError, match="f16 staging"):
            ms.mrf_stage(x, blocks, dils, k, packed=unstaged)
        bf = [{cs: [{kk: v.to(torch.bfloat16) for kk, v in c.items()} for c in b[cs]]
               for cs in ("convs1", "convs2")} for b in pt["vocoder"]["blocks"][:3]]
        with pytest.raises(TypeError, match="f16_staging"):
            ms.mrf_stage(torch.zeros(1, 8, 16, dtype=torch.bfloat16), bf,
                         TINY_CONFIG.resblock_dilations, TINY_CONFIG.resblock_kernel_size)
    assert ms.kernel_mode(torch.float32) == "f32"
    assert ms.kernel_mode(torch.bfloat16) == "bf16"
    with tconv.f16_staging():
        assert ms.kernel_mode(torch.float32) == "f16_staged"


def test_production_vocoder_staged_takes_the_kernel(monkeypatch):
    """Under f16_staging every production stage goes to the kernel's
    wrapper with the staging on (meta tensors stand for the card), none to
    the plain version; the input and output convs are staged through
    ops.conv."""
    prod = ZeroVoxConfig()
    from test_torch_mrf import _meta_vocoder
    calls, convs = [], []
    monkeypatch.setattr(hifigan, "mrf_stage",
                        lambda x, blocks, *a, upsample=None, packed=None, **kw: calls.append(
                            (blocks[0]["convs1"][0]["w"].shape[0], tconv.staging()))
                        or torch.empty(x.shape[0], x.shape[1] * upsample["stride"],
                                       blocks[0]["convs1"][0]["w"].shape[0], device="meta"))
    monkeypatch.setattr(hifigan, "mrf_stage_ref", None)      # never called
    real = hifigan.conv1d
    monkeypatch.setattr(hifigan, "conv1d",
                        lambda *a, **k: convs.append(tconv.staging()) or real(*a, **k))
    mel = torch.empty(1, 16, prod.num_mels, device="meta")
    with torch.no_grad(), tconv.f16_staging():
        wav = hifigan.vocode(_meta_vocoder(prod), prod, mel)
    assert calls == [(256, True), (128, True), (64, True), (32, True)]
    assert convs == [True, True] and wav.shape == (1, 16 * prod.hop_size)


# --------------------------------------------------------------------------
# the stages
# --------------------------------------------------------------------------

def test_encode_staged_tiny(tiny):
    """encode -> durations_from_log -> length_regulate, both staged, on the
    verify probe's draw: the same frame count, the hidden state within a
    quarter of the encoder band."""
    pj, pt = tiny
    from zerovox_tpu_torch.utils.verify import probe_utterance
    src, pun, style = probe_utterance(TINY_CONFIG, seed=7)
    T = TINY_CONFIG.max_seq_len
    with jconv.f16_staging():
        feat, log_dur = jax.jit(lambda s, p, y: j_enc.encode(pj, J_TINY, s, p, y))(
            jnp.asarray(src[None]), jnp.asarray(pun[None]), jnp.asarray(style[None]))
    ref, total = j_regulate(feat, j_durations(log_dur, T), T)
    with tconv.f16_staging():
        tf, tl = fs2_encoder.encode(pt, TINY_CONFIG, torch.from_numpy(src).long()[None],
                                    torch.from_numpy(pun).long()[None],
                                    torch.from_numpy(style)[None])
        got, got_total = length_regulate(tf, durations_from_log(tl, T), T)
    assert int(got_total[0]) == int(total[0]) > T // 4
    _within_band("encoder hidden", got[0].numpy(), ref[0], _encoder_band)


def test_decode_staged_tiny(rng, tiny):
    pj, pt = tiny
    hidden = rng.normal(size=(1, TINY_CONFIG.max_seq_len, TINY_CONFIG.d_model)).astype(np.float32)
    style = rng.normal(scale=0.1, size=(1, TINY_CONFIG.d_model)).astype(np.float32)
    with jconv.f16_staging():
        ref = jax.jit(lambda h, s: j_dec.decode(pj, J_TINY, h, s))(hidden, style)
    with tconv.f16_staging():
        got = styletts_decoder.decode(pt, TINY_CONFIG, torch.from_numpy(hidden),
                                      torch.from_numpy(style))
    _within_band("decoder mel", got[0].numpy(), ref[0], _decoder_band, quarter=0.5)


def _mel(rng, params, cfg, frames):
    mean = np.asarray(params["vocoder"]["mean"])
    scale = np.asarray(params["vocoder"]["scale"])
    return (rng.normal(size=(1, frames, cfg.num_mels)) * scale + mean).astype(np.float32)


def test_vocode_staged_tiny(rng, tiny):
    pj, pt = tiny
    mel = _mel(rng, pj, J_TINY, J_TINY.max_seq_len)
    with jconv.f16_staging():
        ref = jax.jit(lambda m: j_voc.vocode(pj, J_TINY, m))(mel)
    with tconv.f16_staging():
        got = hifigan.vocode(pt, TINY_CONFIG, torch.from_numpy(mel))
    _within_band("vocoder wav (TINY)", got[0].numpy(), ref[0], _vocoder_band)


def test_vocode_staged_production_width(rng):
    """Production widths (C = 512 in, stages 256/128/64/32) on 24 mel
    frames: the port's stages run mrf_stage_ref on the CPU, staged through
    ops.conv; the JAX vocoder its folded XLA route, staged."""
    jcfg, tcfg = JConfig(max_seq_len=24), ZeroVoxConfig(max_seq_len=24)
    pj, pt = _pair(jcfg, tcfg, seed=1)
    mel = _mel(rng, pj, jcfg, 24)
    with jconv.f16_staging():
        ref = jax.jit(lambda m: j_voc.vocode(pj, jcfg, m))(mel)
    with tconv.f16_staging():
        got = hifigan.vocode(pt, tcfg, torch.from_numpy(mel))
    _within_band("vocoder wav (production width, 24 frames)", got[0].numpy(), ref[0],
                 _vocoder_band)
