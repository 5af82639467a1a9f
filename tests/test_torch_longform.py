"""The port's long-form synthesis (runtime/longform.py) on the CPU: the
counterpart of tests/test_longform.py without its server case (the daemon
is not ported yet).  The split is integer logic and must equal the JAX
package's exactly; synthesize_long must equal the per-window engine calls
(atol 1e-6, as there) and the JAX synthesize_long (wav atol 1e-3 / rtol 1e-3).
"""

import json

import numpy as np
import pytest

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.runtime import longform as jlong
from zerovox_tpu.runtime.engine import TTSEngine as JEngine

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch import cli as tcli
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.io.wav import float_to_pcm16, read_wav
from zerovox_tpu_torch.runtime.engine import TTSEngine
from zerovox_tpu_torch.runtime.longform import split_points, split_utterance, synthesize_long

CFG = TINY_CONFIG


def test_split_points_prefers_punctuation():
    pu = [0, 0, 0, 2, 0, 0, 0, 0, 0, 1, 0, 0]
    assert split_points(pu, n=12, cap=8) == [4, 12]
    assert split_points([0] * 20, n=20, cap=8) == [8, 16, 20]
    with pytest.raises(ValueError):
        split_points(pu, n=12, cap=0)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100])
def test_split_points_partitions_everything_as_jax(n):
    rng = np.random.default_rng(n)
    pu = rng.integers(0, 3, size=n)
    ends = split_points(pu, n=n, cap=8)
    assert ends == jlong.split_points(pu, n=n, cap=8) and ends[-1] == n
    prev = 0
    for e in ends:
        assert 1 <= e - prev <= 8
        prev = e


def test_split_utterance_shapes():
    cap = CFG.max_n_phonemes
    n = int(cap * 2.5)
    rng = np.random.default_rng(1)
    ph = rng.integers(1, CFG.num_phonemes, size=n)
    pu = rng.integers(0, CFG.num_puncts, size=n)
    src, pun, lens = split_utterance(ph, pu, cap)
    for a, b in zip((src, pun, lens), jlong.split_utterance(ph, pu, cap)):
        np.testing.assert_array_equal(a, b)
    assert src.shape == pun.shape == (len(lens), cap) and src.dtype == np.int32
    assert int(lens.sum()) == n
    back = np.concatenate([src[i, :lens[i]] for i in range(len(lens))])
    np.testing.assert_array_equal(back, ph.astype(np.int32))
    with pytest.raises(ValueError):
        split_utterance(ph, pu[:-1], cap)


@pytest.fixture(scope="module")
def engines():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY), CFG, device="cpu")
    return JEngine(pj, J_TINY, mel_buckets=(16, 32)), \
        TTSEngine(pt, CFG, mel_buckets=(16, 32), device="cpu"), pt


def _long_utterance(seed, n):
    rng = np.random.default_rng(seed)
    ph = rng.integers(1, CFG.num_phonemes, size=n)
    pu = rng.integers(0, CFG.num_puncts, size=n)
    style = rng.normal(scale=0.1, size=(1, CFG.d_model)).astype(np.float32)
    return ph, pu, style


def test_synthesize_long_matches_per_window(engines):
    je, te, _ = engines
    cap = CFG.max_n_phonemes
    ph, pu, style = _long_utterance(2, int(cap * 2.5))
    wav, mel_len = synthesize_long(te, ph, pu, style)
    src, pun, lens = split_utterance(ph, pu, cap)
    parts = [te.synthesize(src[i:i + 1], pun[i:i + 1], style, num_phonemes=lens[i:i + 1])[0][0]
             for i in range(len(lens))]
    ref = np.concatenate(parts)
    assert len(wav) == len(ref) == int(mel_len.sum()) * CFG.hop_size
    np.testing.assert_allclose(wav, ref, atol=1e-6)
    jwav, jlen = jlong.synthesize_long(je, ph, pu, style)
    np.testing.assert_array_equal(mel_len, jlen)
    np.testing.assert_allclose(wav, jwav, atol=1e-3, rtol=1e-3)
    pcm, _ = synthesize_long(te, ph, pu, style, pcm16=True)
    np.testing.assert_array_equal(pcm, float_to_pcm16(wav))


def test_synthesize_long_window_cap(engines):
    """max_windows bounds the device work of one call: a split into more
    windows raises before any of them runs; one at the cap passes."""
    _, te, _ = engines
    cap = CFG.max_n_phonemes
    n = cap * 3 + 1                                    # 4 hard-cap windows
    ph, _, style = _long_utterance(9, n)
    pu = np.zeros(n, np.int64)
    with pytest.raises(ValueError, match="windows"):
        synthesize_long(te, ph, pu, style, max_windows=3)
    wav, mel_len = synthesize_long(te, ph, pu, style, max_windows=4)
    assert len(mel_len) == 4 and wav.size > 0


@pytest.mark.parametrize("stream", [False, True])
def test_cli_split_long(tmp_path, engines, stream):
    """--split-long takes an utterance longer than max_n_phonemes from a JSON
    file (one-shot: the engine's packed batch; --stream: window after window
    into one file); without it the over-long input is refused."""
    _, te, pt = engines
    ckpt = str(tmp_path / "m.gguf")
    tparams.save_params(ckpt, pt, CFG)
    ph, pu, style = _long_utterance(4, CFG.max_n_phonemes * 2 + 3)
    inp = tmp_path / "long.json"
    inp.write_text(json.dumps({"phonemes": ph.tolist(), "puncts": pu.tolist(),
                               "style": style[0].tolist()}))
    out = str(tmp_path / "long.wav")
    argv = ["--model", ckpt, "--input", str(inp), "--output", out, "--device", "cpu"]
    with pytest.raises(SystemExit, match="max_n_phonemes"):
        tcli.main(argv)
    extra = ["--stream", "--chunk-frames", "16", "--overlap", "8"] if stream else []
    assert tcli.main(argv + ["--split-long"] + extra) == 0
    wav, rate = read_wav(out)
    cfg, loaded = tparams.load_params(ckpt, device="cpu")      # the file's f16 conv kernels
    ref, mel_len = synthesize_long(TTSEngine(loaded, cfg, device="cpu"), ph, pu, style)
    assert rate == CFG.sampling_rate and len(mel_len) == 3
    if stream:
        # every window streams whole chunks: at least the trimmed audio, chunk-aligned
        assert len(wav) >= len(ref) and len(wav) % (16 * CFG.hop_size) == 0
    else:
        np.testing.assert_array_equal(wav, float_to_pcm16(ref).astype(np.float32) / 32767.0)
    with pytest.raises(SystemExit):                            # needs --input
        tcli.main(["--model", ckpt, "--demo", "--split-long", "--device", "cpu"])
