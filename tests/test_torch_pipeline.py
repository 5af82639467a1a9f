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
    """What synthesize still rejects is a compute_dtype it does not know;
    bfloat16, which it refused before the bf16 serving path was ported, runs
    (test_synthesize_bf16 holds it against the JAX package)."""
    _, pt = model
    args = (np.zeros((1, 16)), np.zeros((1, 16)), np.zeros((1, TINY_CONFIG.d_model)))
    with pytest.raises(ValueError, match="compute_dtype"):
        synthesize(pt, TINY_CONFIG.replace(compute_dtype="float16"), *args, device="cpu")
    out = synthesize(cast_params(pt, torch.bfloat16),
                     TINY_CONFIG.replace(compute_dtype="bfloat16"), *args, device="cpu")
    assert out.wav.dtype == out.mel.dtype == torch.bfloat16
    assert cast_params(pt, torch.float64)["vocoder"]["mean"].dtype == torch.float64
    assert cast_params(pt, torch.bfloat16)["vocoder"]["mean"].dtype == torch.bfloat16


def test_synthesize_bf16(rng, model):
    """The slice as a whole in the serving dtype, against the JAX package's
    synthesize run eagerly (under jit XLA drops some bf16 roundings; see
    test_torch_stages.py) on weights cast from the same f32 tree.  A last-bit
    difference in a log-duration can flip floor(exp(ld) - 0.5) and shift
    every later sample, so the inputs are checked to keep a margin from that
    boundary, and then: equal durations and mel_len, the mel within 6 bf16
    ulps of max|mel| (the decoder's tolerance), and a finite waveform of the
    right shape inside [-1, 1] within 8 ulps of max|wav| of JAX's (the
    vocoder's 6, on mels that differ)."""
    from zerovox_tpu.models.pipeline import cast_params as j_cast, synthesize as j_synthesize
    pj, pt = model
    jcfg = J_TINY.replace(compute_dtype="bfloat16")
    tcfg = TINY_CONFIG.replace(compute_dtype="bfloat16")
    src, pun, sty, n = _batch(rng, 2, (16, 11))
    ref = j_synthesize(j_cast(pj, jnp.bfloat16), jcfg, jnp.asarray(src), jnp.asarray(pun),
                       jnp.asarray(sty), jnp.asarray(n))
    got = synthesize(cast_params(pt, torch.bfloat16), tcfg, src, pun, sty, n, device="cpu")
    frac = np.exp(np.asarray(ref.log_duration.astype(jnp.float32))) - 0.5
    assert np.abs(frac - np.round(frac)).min() > 0.02, "inputs sit on a duration boundary"
    np.testing.assert_array_equal(
        durations_from_log(got.log_duration, tcfg.max_seq_len).numpy(),
        np.asarray(j_durations(ref.log_duration, jcfg.max_seq_len)))
    np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(ref.mel_len))
    assert int(got.mel_len.min()) > 0
    mel_r = np.asarray(ref.mel.astype(jnp.float32))
    assert np.abs(got.mel.float().numpy() - mel_r).max() <= 6 * 2.0 ** -8 * np.abs(mel_r).max()
    wav, wav_r = got.wav.float().numpy(), np.asarray(ref.wav.astype(jnp.float32))
    assert wav.shape == wav_r.shape == (2, tcfg.wav_len)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert np.abs(wav - wav_r).max() <= 8 * 2.0 ** -8 * np.abs(wav_r).max()


def test_engine_bf16(rng, model):
    """TTSEngine(precision="bfloat16"): weights cast once, cfg switched to
    the bf16 compute dtype, float32 waveforms handed back; its buckets,
    packing and trimming give what synthesize gives on the cast weights (the
    vocoder sees the same mel cut at a bucket: equal on the trimmed part)."""
    _, pt = model
    te = TTSEngine(pt, TINY_CONFIG, mel_buckets=(24, 40), batch_ladder=(1, 2, 4),
                   precision="bfloat16", device="cpu")
    assert te.cfg.compute_dtype == "bfloat16" and TINY_CONFIG.compute_dtype == "float32"
    assert te.params["vocoder"]["input_conv_w"].dtype == torch.bfloat16
    assert te.vocoder_packed is None                        # packed on a card only
    src, pun, sty, n = _batch(rng, 3, (16, 3, 9))
    wavs, lens = te.synthesize(src, pun, sty, n)
    ref = synthesize(te.params, te.cfg, src, pun, sty, n, device="cpu")
    np.testing.assert_array_equal(lens, ref.mel_len.numpy())
    for i, w in enumerate(wavs):
        assert w.dtype == np.float32 and len(w) == int(lens[i]) * TINY_CONFIG.hop_size
        np.testing.assert_allclose(w, ref.wav[i, :len(w)].float().numpy(), rtol=0,
                                   atol=2 * 2.0 ** -8)
    packed, plens = te.synthesize_packed(src, pun, sty, n)
    np.testing.assert_array_equal(plens, lens)
    for a, b in zip(packed, wavs):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * 2.0 ** -8)
    pcm, _ = te.synthesize(src, pun, sty, n, pcm16=True)
    for p, w in zip(pcm, wavs):
        np.testing.assert_array_equal(p, float_to_pcm16(w))


def test_reload_params(rng, model):
    """reload_params swaps in weights of the same geometry (cast again for a
    bf16 engine) and rejects any other tree."""
    _, pt = model
    other = tparams.init_params(TINY_CONFIG, seed=5, device="cpu")
    src, pun, sty, n = _batch(rng, 1, (16,))
    for precision in ("float32", "bfloat16"):
        te = TTSEngine(pt, TINY_CONFIG, mel_buckets=(24,), precision=precision, device="cpu")
        before, _ = te.synthesize(src, pun, sty, n, trim=False)
        te.reload_params(other)
        assert te.params["vocoder"]["input_conv_w"].dtype == (
            torch.bfloat16 if precision == "bfloat16" else torch.float32)
        after, _ = te.synthesize(src, pun, sty, n, trim=False)
        fresh, _ = TTSEngine(other, TINY_CONFIG, mel_buckets=(24,), precision=precision,
                             device="cpu").synthesize(src, pun, sty, n, trim=False)
        np.testing.assert_array_equal(after[0], fresh[0])
        assert not np.array_equal(after[0], before[0])
        wide = tparams.init_params(TINY_CONFIG.replace(hifigan_channels=64), seed=0,
                                   device="cpu")
        with pytest.raises(ValueError, match="geometry"):
            te.reload_params(wide)
        missing = {k: v for k, v in other.items() if k != "decoder"}
        with pytest.raises(ValueError, match="tree"):
            te.reload_params(missing)
        again, _ = te.synthesize(src, pun, sty, n, trim=False)
        np.testing.assert_array_equal(again[0], after[0])   # a rejected reload changes nothing


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_synthesize_async_and_single_rtt(rng, model, precision):
    """synthesize_async launches everything and fetch() collects it: the
    same mel_len and waveforms as synthesize (the vocoder runs at the largest
    bucket instead of the request's, which leaves the trimmed part equal to
    atol 2e-5 in f32 and 2 bf16 ulps in bf16), for a batch larger than the
    ladder top too; single_rtt=True is that path bit for bit, and is off by
    default."""
    pj, pt = model
    te = TTSEngine(pt, TINY_CONFIG, mel_buckets=(24, 40), batch_ladder=(1, 2),
                   precision=precision, device="cpu")
    atol = 2e-5 if precision == "float32" else 2 * 2.0 ** -8
    src, pun, sty, n = _batch(rng, 3, (16, 5, 11))            # 3 > ladder top 2
    want, want_len = te.synthesize(src, pun, sty, n)
    fetch = te.synthesize_async(src, pun, sty, n)
    got, got_len = fetch()
    np.testing.assert_array_equal(got_len, want_len)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
    one, one_len = te.synthesize(src, pun, sty, n, single_rtt=True)
    np.testing.assert_array_equal(one_len, want_len)
    for a, b in zip(one, got):
        np.testing.assert_array_equal(a, b)
    full, _ = te.synthesize_async(src, pun, sty, n, trim=False, pcm16=True)()
    assert all(w.shape == (TINY_CONFIG.wav_len,) and w.dtype == np.int16 for w in full)
    if precision == "float32":                                # and the JAX engine's
        je = JEngine(pj, J_TINY, mel_buckets=(24, 40), batch_ladder=(1, 2))
        jw, jl = je.synthesize_async(src, pun, sty, n)()
        np.testing.assert_array_equal(got_len, jl)
        for a, b in zip(got, jw):
            np.testing.assert_allclose(a, b, **WAV)
    with pytest.raises(ValueError):
        te.synthesize_async(src[:0], pun[:0], sty[:0])


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
    assert TTSEngine(pt, TINY_CONFIG, precision="bfloat16",
                     device="cpu").cfg.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="precision"):
        TTSEngine(pt, TINY_CONFIG, precision="float16", device="cpu")
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
    out16 = str(tmp_path / "o16.wav")
    assert tcli.main(["--model", ckpt, "--input", str(inp), "--output", out16,
                      "--device", "cpu", "--precision", "bfloat16"]) == 0
    w16 = read_wav(out16)[0]
    assert len(w16) > 0 and np.isfinite(w16).all()
    with pytest.raises(SystemExit, match="not yet ported"):
        tcli.main(["--model", ckpt, "--demo", "--device", "cpu", "--verify"])
    with pytest.raises(ValueError, match="max_n_phonemes"):
        utterance_from_dict({"phonemes": [1] * 17, "style": utt["style"]}, TINY_CONFIG)


def test_wav_roundtrip(tmp_path, rng):
    x = np.clip(rng.normal(scale=0.5, size=1000), -1.2, 1.2).astype(np.float32)
    p = str(tmp_path / "a.wav")
    write_wav(p, x, 24000)
    y, sr = read_wav(p)
    assert sr == 24000
    np.testing.assert_array_equal(y, float_to_pcm16(x).astype(np.float32) / 32767.0)


def test_serving_threads_issue_one_at_a_time(rng, model, monkeypatch):
    """The engine and the streaming synthesizer issue every front and every
    vocoder call on their device's one issuing thread (device.on_issuing_thread): with 4
    threads on each at once, pipeline.front and hifigan.vocode only ever run
    on that thread, never two at a time, and every result is the
    single-threaded one.  A debug capture around an engine call still sees
    the taps made over there."""
    import threading
    import time
    from zerovox_tpu_torch.device import on_issuing_thread
    from zerovox_tpu_torch.models import hifigan, streaming
    from zerovox_tpu_torch.models.streaming import StreamingSynthesizer
    from zerovox_tpu_torch.runtime import engine as engine_mod
    from zerovox_tpu_torch.utils.debug import capture_run
    _, pt = model
    engine = TTSEngine(pt, TINY_CONFIG, device="cpu")
    synth = StreamingSynthesizer(engine.model, TINY_CONFIG, chunk_frames=16, overlap=8,
                                 device="cpu")
    src, pun, sty, n = _batch(rng, 1, (16,))
    want = engine.synthesize(src, pun, sty, n)[0][0]
    want_stream = np.concatenate(list(synth.stream(src, pun, sty, n)), axis=1)
    inside, worst, guard, where = [0], [0], threading.Lock(), set()

    def watched(fn):
        def run(*a, **k):
            with guard:
                inside[0] += 1
                worst[0] = max(worst[0], inside[0])
                where.add(threading.get_ident())
            try:
                time.sleep(0.002)               # give another thread every chance to enter
                return fn(*a, **k)
            finally:
                with guard:
                    inside[0] -= 1
        return run

    monkeypatch.setattr(engine_mod, "front", watched(engine_mod.front))
    monkeypatch.setattr(streaming, "front", watched(streaming.front))
    monkeypatch.setattr(hifigan, "vocode", watched(hifigan.vocode))
    results, errors = [None] * 8, []

    def worker(i):
        try:
            for _ in range(3):
                results[i] = (engine.synthesize(src, pun, sty, n)[0][0] if i % 2 else
                              np.concatenate(list(synth.stream(src, pun, sty, n)), axis=1))
        except Exception as e:          # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and worst[0] == 1, (errors, worst)
    cpu = torch.device("cpu")
    issuer = on_issuing_thread(cpu, threading.get_ident)
    assert where == {issuer} and threading.get_ident() not in where
    assert on_issuing_thread(cpu, on_issuing_thread, cpu, threading.get_ident) == issuer   # inline from there
    # one thread per device: another device has its own, reached from this one too
    other = on_issuing_thread(torch.device("meta"), threading.get_ident)
    assert other not in (issuer, threading.get_ident())
    assert on_issuing_thread(cpu, on_issuing_thread, "meta", threading.get_ident) == other
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r, want if i % 2 else want_stream)
    with pytest.raises(ZeroDivisionError):      # the caller gets the exception
        on_issuing_thread(cpu, lambda: 1 / 0)
    (wavs, _), taps = capture_run(engine.synthesize, src, pun, sty, n, trim=False)
    assert {"encoder_output", "mel", "wav"} <= set(taps)
    np.testing.assert_array_equal(taps["wav"].numpy()[0], wavs[0])
