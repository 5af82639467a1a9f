"""End to end at TINY: the port's synthesize, TTSEngine and CLI against the
JAX package's on the CPU.

Durations and mel_len must match exactly; mel within atol 5e-3 / rtol 1e-3
and wav within atol 1e-3 / rtol 1e-3 (docs/ARCHITECTURE.md §10); the
CLI's PCM16 within 1 LSB.  The JAX reference pipeline runs under its
jit_synthesize, as the JAX engine runs it.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.cli as jcli
import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.io.wav import read_wav as j_read_wav
from zerovox_tpu.models.pipeline import jit_synthesize as j_jit_synthesize
from zerovox_tpu.ops import durations_from_log as j_durations
from zerovox_tpu.runtime.engine import TTSEngine as JEngine

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch import cli as tcli
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.io.wav import float_to_pcm16, read_wav, write_wav
from zerovox_tpu_torch.models.pipeline import cast_params, synthesize
from zerovox_tpu_torch.ops import durations_from_log
from zerovox_tpu_torch.runtime.engine import TTSEngine
from zerovox_tpu_torch.runtime.utterance import utterance_from_dict

MEL = dict(atol=5e-3, rtol=1e-3)
WAV = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def model():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY),
                                    TINY_CONFIG, device="cpu")
    return pj, pt


def _batch(rng, B, lens):
    cfg = TINY_CONFIG
    P = cfg.max_n_phonemes
    src = np.zeros((B, P), np.int32)
    pun = np.zeros((B, P), np.int32)
    for i, L in enumerate(lens):
        src[i, :L] = rng.integers(1, cfg.num_phonemes + 1, size=L)
        pun[i, :L] = rng.integers(0, cfg.num_puncts + 1, size=L)
    sty = rng.normal(scale=0.1, size=(B, cfg.d_model)).astype(np.float32)
    return src, pun, sty, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens,pass_n", [((16, 16), False), ((16, 5, 11), True)])
def test_synthesize_matches_jax(rng, model, lens, pass_n):
    pj, pt = model
    src, pun, sty, n = _batch(rng, len(lens), lens)
    ref = j_jit_synthesize(pj, J_TINY)(pj, jnp.asarray(src), jnp.asarray(pun),
                                        jnp.asarray(sty), jnp.asarray(n) if pass_n else None)
    got = synthesize(pt, TINY_CONFIG, src, pun, sty, n if pass_n else None,
                     device="cpu")
    np.testing.assert_array_equal(
        durations_from_log(got.log_duration, TINY_CONFIG.max_seq_len).numpy(),
        np.asarray(j_durations(ref.log_duration, J_TINY.max_seq_len)))
    np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(ref.mel_len))
    assert int(got.mel_len.min()) > 0
    np.testing.assert_allclose(got.mel.numpy(), np.asarray(ref.mel), **MEL)
    np.testing.assert_allclose(got.wav.numpy(), np.asarray(ref.wav), **WAV)


def test_synthesize_rejects_bf16(model):
    _, pt = model
    with pytest.raises(NotImplementedError):
        synthesize(pt, TINY_CONFIG.replace(compute_dtype="bfloat16"),
                   np.zeros((1, 16)), np.zeros((1, 16)),
                   np.zeros((1, TINY_CONFIG.d_model)), device="cpu")
    assert cast_params(pt, torch.float64)["vocoder"]["mean"].dtype == torch.float64


def test_engine_matches_jax(rng, model):
    """synthesize (B=1 and a mixed B=3) and synthesize_packed: same buckets,
    mel_len and trimmed waveforms as the JAX engine."""
    pj, pt = model
    kw = dict(mel_buckets=(24, 40), batch_ladder=(1, 2, 4))
    je = JEngine(pj, J_TINY, **kw)
    te = TTSEngine(pt, TINY_CONFIG, device="cpu", **kw)
    assert te.mel_buckets == je.mel_buckets and te.margin == je.margin
    for lens in ((16,), (16, 3, 9)):
        src, pun, sty, n = _batch(rng, len(lens), lens)
        jw, jl = je.synthesize(src, pun, sty, n)
        tw, tl = te.synthesize(src, pun, sty, n)
        np.testing.assert_array_equal(tl, jl)
        assert [te.pick_bucket(m) for m in tl] == [je.pick_bucket(m) for m in jl]
        for a, b in zip(tw, jw):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **WAV)
        pw, pl = te.synthesize_packed(src, pun, sty, n)
        jpw, _ = je.synthesize_packed(src, pun, sty, n)
        np.testing.assert_array_equal(pl, jl)
        assert te.group_by_bucket(pl) == je.group_by_bucket(jl)
        for a, b in zip(pw, jpw):
            np.testing.assert_allclose(a, b, **WAV)


def test_engine_untrimmed_and_pcm16(rng, model):
    _, pt = model
    te = TTSEngine(pt, TINY_CONFIG, mel_buckets=(24,), device="cpu")
    src, pun, sty, n = _batch(rng, 2, (16, 4))
    full, _ = te.synthesize(src, pun, sty, n, trim=False)
    assert all(w.shape == (TINY_CONFIG.wav_len,) for w in full)
    pcm, lens = te.synthesize_packed(src, pun, sty, n, pcm16=True)
    trimmed, _ = te.synthesize_packed(src, pun, sty, n)
    for p, w in zip(pcm, trimmed):
        assert p.dtype == np.int16
        np.testing.assert_array_equal(p, float_to_pcm16(w))
    te.warmup(batch=2, pcm16=True)
    with pytest.raises(NotImplementedError):
        TTSEngine(pt, TINY_CONFIG, precision="bfloat16", device="cpu")
    with pytest.raises(ValueError):
        te.synthesize(src[:0], pun[:0], sty[:0])


@pytest.mark.parametrize("extra", [[], ["--no-trim"]])
def test_cli_matches_jax_cli(tmp_path, model, extra):
    pj, _ = model
    ckpt = str(tmp_path / "m.gguf")
    jparams.save_params(ckpt, pj, J_TINY)
    jwav, twav = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert jcli.main(["--model", ckpt, "--demo", "--output", jwav] + extra) == 0
    assert tcli.main(["--model", ckpt, "--demo", "--output", twav,
                      "--device", "cpu"] + extra) == 0
    a, ra = j_read_wav(jwav)
    b, rb = read_wav(twav)
    assert ra == rb == TINY_CONFIG.sampling_rate
    assert a.shape == b.shape and len(a) > 0
    assert np.abs(np.round(a * 32767) - np.round(b * 32767)).max() <= 1


def test_cli_input_file_and_unported_flags(tmp_path, rng, model):
    _, pt = model
    ckpt = str(tmp_path / "m.gguf")
    tparams.save_params(ckpt, pt, TINY_CONFIG)
    utt = {"phonemes": [3, 7, 9, 12, 1, 5], "puncts": [0, 0, 1, 0, 0, 2],
           "style": rng.normal(scale=0.1, size=TINY_CONFIG.d_model).tolist()}
    inp = tmp_path / "utt.json"
    inp.write_text(json.dumps(utt))
    out = str(tmp_path / "o.wav")
    assert tcli.main(["--model", ckpt, "--input", str(inp), "--output", out,
                      "--device", "cpu"]) == 0
    src, pun, style, n = utterance_from_dict(utt, TINY_CONFIG)
    cfg, loaded = tparams.load_params(ckpt, device="cpu")    # f16 conv kernels
    wavs, _ = TTSEngine(loaded, cfg, device="cpu").synthesize(src, pun, style, n)
    expect = float_to_pcm16(wavs[0]).astype(np.float32) / 32767.0
    np.testing.assert_array_equal(read_wav(out)[0], expect)
    for flag in ("--stream", "--serve", "--split-long", "--verify",
                 "--mesh=2,1", "--compile-cache=/tmp/x"):
        with pytest.raises(SystemExit, match="not yet ported"):
            tcli.main(["--model", ckpt, "--demo", "--device", "cpu", flag])
    with pytest.raises(ValueError, match="max_n_phonemes"):
        utterance_from_dict({"phonemes": [1] * 17, "style": utt["style"]}, TINY_CONFIG)


def test_wav_roundtrip(tmp_path, rng):
    x = np.clip(rng.normal(scale=0.5, size=1000), -1.2, 1.2).astype(np.float32)
    p = str(tmp_path / "a.wav")
    write_wav(p, x, 24000)
    y, sr = read_wav(p)
    assert sr == 24000
    np.testing.assert_array_equal(y, float_to_pcm16(x).astype(np.float32) / 32767.0)
