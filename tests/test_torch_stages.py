"""The port's three stages against the JAX package's, on the CPU.

TINY (docs/ARCHITECTURE.md §10 tolerances): features atol 5e-5 / rtol 1e-4,
mel atol 5e-3 / rtol 1e-3, wav atol 1e-3 / rtol 1e-3.  Production widths
with a 16-frame max_seq_len, each stage fed identical inputs: decoder atol
5e-3 / rtol 1e-3, vocoder atol 2e-3 / rtol 1e-3.  (A chained production
diff is not attempted: bucketize flips make it impossible for any
reimplementation, §10.)  The JAX references run under jax.jit, which
compiles each stage once instead of every primitive on its own.
"""

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

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
from zerovox_tpu_torch.models import fs2_encoder, hifigan, styletts_decoder
from zerovox_tpu_torch.ops.cuda.mrf_stage import pack_stage


def _pair(jcfg, tcfg, seed=0):
    pj = jparams.init_params(jcfg, seed=seed)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, jcfg), tcfg,
                                    device="cpu")
    return pj, pt


def _jit_decode(jcfg):
    return jax.jit(lambda p, h, s: j_dec.decode(p, jcfg, h, s))


def _jit_vocode(jcfg):
    return jax.jit(lambda p, m: j_voc.vocode(p, jcfg, m))


@pytest.fixture(scope="module")
def tiny():
    return _pair(J_TINY, TINY_CONFIG)


@pytest.fixture(scope="module")
def prod():
    jcfg = JConfig(max_seq_len=16)
    tcfg = ZeroVoxConfig(max_seq_len=16)
    return jcfg, tcfg, _pair(jcfg, tcfg)


@pytest.mark.parametrize("masked", [False, True])
def test_encode_tiny(rng, tiny, masked):
    pj, pt = tiny
    jcfg = J_TINY.replace(use_attention_mask=masked)
    tcfg = TINY_CONFIG.replace(use_attention_mask=masked)
    P = TINY_CONFIG.max_n_phonemes
    src = rng.integers(1, TINY_CONFIG.num_phonemes + 1, size=(2, P))
    pun = rng.integers(0, TINY_CONFIG.num_puncts + 1, size=(2, P))
    sty = rng.normal(scale=0.1, size=(2, TINY_CONFIG.d_model)).astype(np.float32)
    n = np.asarray([P, 9])
    fj, lj = jax.jit(lambda p, s, u, y, m: j_enc.encode(p, jcfg, s, u, y, phoneme_mask=m))(
        pj, jnp.asarray(src), jnp.asarray(pun), jnp.asarray(sty),
        j_enc.phoneme_mask(jnp.asarray(n), P))
    ft, lt = fs2_encoder.encode(pt, tcfg, torch.from_numpy(src), torch.from_numpy(pun),
                                torch.from_numpy(sty),
                                phoneme_mask=fs2_encoder.phoneme_mask(torch.from_numpy(n), P))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=5e-5, rtol=1e-4)


def test_decode_tiny(rng, tiny):
    pj, pt = tiny
    hidden = rng.normal(size=(2, TINY_CONFIG.max_seq_len, TINY_CONFIG.d_model)).astype(np.float32)
    hidden[1, 40:] = 0.0                                    # zero-padded tail
    sty = rng.normal(scale=0.1, size=(2, TINY_CONFIG.d_model)).astype(np.float32)
    ref = _jit_decode(J_TINY)(pj, jnp.asarray(hidden), jnp.asarray(sty))
    got = styletts_decoder.decode(pt, TINY_CONFIG, torch.from_numpy(hidden),
                                  torch.from_numpy(sty))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("backend", ["auto", "native"])
def test_vocode_tiny(rng, tiny, backend):
    pj, pt = tiny
    mel = rng.normal(size=(2, 40, TINY_CONFIG.num_mels)).astype(np.float32)
    ref = _jit_vocode(J_TINY.replace(vocoder_backend="native"))(pj, jnp.asarray(mel))
    got = hifigan.vocode(pt, TINY_CONFIG.replace(vocoder_backend=backend),
                         torch.from_numpy(mel))
    assert got.shape == (2, 40 * TINY_CONFIG.hop_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_vocode_packed_weights_on_cpu(rng, tiny):
    """On the CPU the stages run the plain version, which reads the tree's
    weights: passing the kernel's packed layout changes nothing."""
    _, pt = tiny
    mel = torch.from_numpy(rng.normal(size=(1, 24, TINY_CONFIG.num_mels)).astype(np.float32))
    packed = hifigan.pack_vocoder(pt, TINY_CONFIG)
    assert len(packed) == len(TINY_CONFIG.upsample_scales)
    torch.testing.assert_close(hifigan.vocode(pt, TINY_CONFIG, mel, packed),
                               hifigan.vocode(pt, TINY_CONFIG, mel), rtol=0, atol=0)


@pytest.mark.parametrize("kernels", [(11, 8, 6), (12, 8, 6)])
def test_vocode_nonstandard_upsample_kernels(rng, kernels):
    """Nonstandard upsample kernels (K != 2s) overshoot and are cropped."""
    jcfg = J_TINY.replace(upsample_kernel_sizes=kernels, vocoder_backend="native")
    tcfg = TINY_CONFIG.replace(upsample_kernel_sizes=kernels)
    pj, pt = _pair(jcfg, tcfg)
    mel = rng.normal(size=(1, 32, tcfg.num_mels)).astype(np.float32)
    ref = _jit_vocode(jcfg)(pj, jnp.asarray(mel))
    got = hifigan.vocode(pt, tcfg, torch.from_numpy(mel))
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_receptive_field_frames():
    for jc, tc in ((J_TINY, TINY_CONFIG), (JConfig(), ZeroVoxConfig())):
        assert hifigan.receptive_field_frames(tc) == j_voc.receptive_field_frames(jc)


def test_decode_production_width(rng, prod):
    jcfg, tcfg, (pj, pt) = prod
    hidden = rng.normal(size=(1, 16, tcfg.d_model)).astype(np.float32)
    sty = rng.normal(scale=0.05, size=(1, tcfg.d_model)).astype(np.float32)
    ref = _jit_decode(jcfg)(pj, jnp.asarray(hidden), jnp.asarray(sty))
    got = styletts_decoder.decode(pt, tcfg, torch.from_numpy(hidden), torch.from_numpy(sty))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-3, rtol=1e-3)


def test_vocode_production_width(rng, prod):
    jcfg, tcfg, (pj, pt) = prod
    mel = rng.normal(size=(1, 16, tcfg.num_mels)).astype(np.float32)
    ref = _jit_vocode(jcfg)(pj, jnp.asarray(mel))
    got = hifigan.vocode(pt, tcfg, torch.from_numpy(mel))
    assert got.shape == (1, 16 * tcfg.hop_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=1e-3)


# --------------------------------------------------------------------------
# bf16 (the serving dtype), each stage fed the same bf16 inputs on both sides
# --------------------------------------------------------------------------
# Both trees are cast from the same f32 weights (cast_params on either side
# rounds to nearest even).  The JAX references run EAGERLY here: under
# jax.jit XLA fuses away some of the bf16 roundings between ops, which moves
# the JAX result itself by a bf16 ulp or two and can flip a pitch or energy
# bucket; eager JAX rounds after every op, as PyTorch does.  A whole-pipeline
# comparison in bf16 would test nothing (one flipped duration shifts every
# later sample), so each stage gets the other side's input.

BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def tiny16(tiny):
    from zerovox_tpu.models.pipeline import cast_params as j_cast
    from zerovox_tpu_torch.models.pipeline import cast_params
    pj, pt = tiny
    return j_cast(pj, jnp.bfloat16), cast_params(pt, torch.bfloat16)


def _j16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _t16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _ulps_of_scale(got, ref):
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    g, r = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert g.shape == r.shape and np.isfinite(g).all()
    return np.abs(g - r).max() / (BF16_ULP * np.abs(r).max())


@pytest.mark.parametrize("masked", [False, True])
def test_encode_bf16(rng, tiny16, masked):
    """Encoder + variance adaptor in bf16: every product is an f32 sum of
    exact products rounded once, the norms take one-pass f32 moments, the
    bucketizers work on f32 casts: features and log-durations within one
    bf16 ulp of their scale of eager JAX (equal, in practice), and so no
    bucket flips."""
    pj, pt = tiny16
    jcfg = J_TINY.replace(use_attention_mask=masked, compute_dtype="bfloat16")
    tcfg = TINY_CONFIG.replace(use_attention_mask=masked, compute_dtype="bfloat16")
    P = TINY_CONFIG.max_n_phonemes
    src = rng.integers(1, TINY_CONFIG.num_phonemes + 1, size=(2, P))
    pun = rng.integers(0, TINY_CONFIG.num_puncts + 1, size=(2, P))
    sty = rng.normal(scale=0.1, size=(2, TINY_CONFIG.d_model)).astype(np.float32)
    n = np.asarray([P, 9])
    fj, lj = j_enc.encode(pj, jcfg, jnp.asarray(src), jnp.asarray(pun), _j16(sty),
                          phoneme_mask=j_enc.phoneme_mask(jnp.asarray(n), P))
    ft, lt = fs2_encoder.encode(pt, tcfg, torch.from_numpy(src), torch.from_numpy(pun),
                                _t16(sty),
                                phoneme_mask=fs2_encoder.phoneme_mask(torch.from_numpy(n), P))
    assert _ulps_of_scale(ft, fj) <= 1.0
    assert _ulps_of_scale(lt, lj) <= 1.0


def test_decode_bf16(rng, tiny16):
    """The decoder on JAX's own bf16 hidden: 6 bf16 ulps of max|mel| (five
    AdaIN blocks, each with two instance norms over the time axis whose f32
    sums the two sides take in another order)."""
    pj, pt = tiny16
    hidden = rng.normal(size=(2, TINY_CONFIG.max_seq_len, TINY_CONFIG.d_model)).astype(np.float32)
    hidden[1, 40:] = 0.0
    sty = rng.normal(scale=0.1, size=(2, TINY_CONFIG.d_model)).astype(np.float32)
    ref = j_dec.decode(pj, J_TINY.replace(compute_dtype="bfloat16"), _j16(hidden), _j16(sty))
    got = styletts_decoder.decode(pt, TINY_CONFIG.replace(compute_dtype="bfloat16"),
                                  _t16(hidden), _t16(sty))
    assert _ulps_of_scale(got, ref) <= 6.0


@pytest.mark.parametrize("backend,ulps", [("pallas", 5.0), ("folded", 6.0)])
def test_vocode_bf16(rng, tiny16, backend, ulps):
    """The vocoder on the same bf16 mel.  "pallas" runs the TPU kernel (in
    interpret mode) where TINY's widths pass its gate (stage 1, C=16 at
    rho=8; the narrower stages take the folded XLA form), "folded" nowhere;
    the folded form keeps its chain state in bf16 between convs where the
    port's stage and the kernel keep it in f32, so the waveforms agree to a
    few bf16 ulps of max|wav|, not to the stage test's 2 ulps per element."""
    pj, pt = tiny16
    mel = rng.normal(size=(2, 40, TINY_CONFIG.num_mels)).astype(np.float32)
    ref = j_voc.vocode(pj, J_TINY.replace(compute_dtype="bfloat16", vocoder_backend=backend),
                       _j16(mel))
    got = hifigan.vocode(pt, TINY_CONFIG.replace(compute_dtype="bfloat16"), _t16(mel))
    assert got.shape == (2, 40 * TINY_CONFIG.hop_size)
    assert _ulps_of_scale(got, ref) <= ulps
    # TINY's stages take the plain route (their widths are not the kernel's),
    # so pack_vocoder packs none of them; the layout of a bf16 stage as such
    assert hifigan.pack_vocoder(pt, TINY_CONFIG) == [None] * len(TINY_CONFIG.upsample_scales)
    n = TINY_CONFIG.num_resblocks
    packed = pack_stage(pt["vocoder"]["blocks"][:n], TINY_CONFIG.resblock_dilations,
                        TINY_CONFIG.resblock_kernel_size, pt["vocoder"]["upsamples"][0]["w"])
    assert packed.w.dtype == torch.bfloat16 and packed.b.dtype == torch.float32
