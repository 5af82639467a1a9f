"""The port's streaming synthesis on the CPU: the chunked vocoder against
the full run, and the stream against the JAX package's StreamingSynthesizer
on the same weights.

The counterpart of tests/test_streaming.py, with its tolerances: chunked
against full atol 2e-5 / rtol 1e-4 (f32), bit equality between `ahead`
settings and between device and host PCM16 quantisation; against JAX the
end-to-end tolerances of docs/ARCHITECTURE.md §10 (wav atol 1e-3 / rtol
1e-3).  The rotation of sessions over several devices is held in
tests/test_torch_engine_mesh.py (the daemon on a mesh).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.models.streaming import StreamingSynthesizer as JStreaming

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch import cli as tcli
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.io.wav import (StreamingWavWriter, float_to_pcm16,
                                      float_to_pcm16_device, read_wav)
from zerovox_tpu_torch.models import hifigan
from zerovox_tpu_torch.models.streaming import StreamingSynthesizer

CFG = TINY_CONFIG
FULL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def model():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY), CFG, device="cpu")
    return pj, pt


def _utterance(rng, B=1):
    src = rng.integers(0, CFG.num_phonemes + 1, size=(B, CFG.max_n_phonemes))
    pun = rng.integers(0, CFG.num_puncts + 1, size=(B, CFG.max_n_phonemes))
    style = rng.normal(scale=0.1, size=(B, CFG.d_model)).astype(np.float32)
    return src, pun, style


def _chunked(s, mel, chunk):
    n_chunks = -(-mel.shape[1] // chunk)
    return torch.cat(list(s.vocode_chunks(mel, n_chunks)), dim=1).numpy()


@pytest.mark.parametrize("chunk,overlap", [(16, 8), (8, 8), (32, 16), (24, 8)])
def test_chunked_vocoder_matches_full(rng, model, chunk, overlap):
    """overlap >= the vocoder's receptive field: the chunks' central parts
    equal the full run (atol 2e-5 / rtol 1e-4: the convs sum in the same
    order on a window as on the whole, up to the library's blocking)."""
    _, pt = model
    mel = torch.from_numpy(rng.normal(size=(1, CFG.max_seq_len, CFG.num_mels)).astype(np.float32))
    full = hifigan.vocode(pt, CFG, mel).numpy()
    s = StreamingSynthesizer(pt, CFG, chunk_frames=chunk, overlap=overlap, device="cpu")
    assert hifigan.receptive_field_frames(CFG) <= overlap
    out = _chunked(s, mel, chunk)
    np.testing.assert_allclose(out[:, :full.shape[1]], full, **FULL)


def test_insufficient_overlap_detectable(rng, model):
    """With overlap=0 the chunk boundaries diverge from the full run by more
    than 1e-4: the parity test above can see a wrong window."""
    _, pt = model
    mel = torch.from_numpy(rng.normal(size=(1, CFG.max_seq_len, CFG.num_mels)).astype(np.float32))
    full = hifigan.vocode(pt, CFG, mel).numpy()
    s = StreamingSynthesizer(pt, CFG, chunk_frames=16, overlap=0, device="cpu")
    assert np.abs(_chunked(s, mel, 16)[:, :full.shape[1]] - full).max() > 1e-4


def test_chunk_plan_matches_jax(model):
    """The window arithmetic, verbatim: same plans for dividing and
    non-dividing chunks, no zero-mel padding (windows end at buffer edges)."""
    pj, pt = model
    for chunk, overlap, T, n in ((64, 16, 1500, 24), (60, 16, 1500, 25), (16, 8, 64, 4),
                                 (24, 8, 64, 3), (7, 8, 64, 2), (64, 0, 96, 2)):
        js = JStreaming(pj, J_TINY, chunk_frames=chunk, overlap=overlap)
        ts = StreamingSynthesizer(pt, CFG, chunk_frames=chunk, overlap=overlap, device="cpu")
        plan = ts.chunk_plan(T, n)
        assert plan == js.chunk_plan(T, n)
        assert all(ws >= 0 and ws + size <= T for ws, size, _, _ in plan)
    assert ts.chunk_plan(1500, 24)[-1] == (1472 - 0, 28, 0, 28)   # overlap 0: the bare tail
    for bad in (dict(chunk_frames=0), dict(overlap=-1), dict(ahead=0)):
        with pytest.raises(ValueError):
            StreamingSynthesizer(pt, CFG, device="cpu", **bad)


def test_stream_end_to_end(rng, model):
    """stream() against the JAX StreamingSynthesizer on the same weights
    (same chunks, wav atol 1e-3 / rtol 1e-3), and against the port's own
    one-shot synthesize on the frames it covers (atol 2e-5 / rtol 1e-4)."""
    from zerovox_tpu_torch.models.pipeline import synthesize
    pj, pt = model
    src, pun, style = _utterance(rng)
    ts = StreamingSynthesizer(pt, CFG, chunk_frames=16, overlap=8, device="cpu")
    ts.warmup()
    chunks = list(ts.stream(src, pun, style))
    ref = list(JStreaming(pj, J_TINY, chunk_frames=16, overlap=8).stream(src, pun, style))
    assert len(chunks) == len(ref) >= 2
    for c, r in zip(chunks, ref):
        assert c.shape == r.shape == (1, 16 * CFG.hop_size) and c.dtype == np.float32
        np.testing.assert_allclose(c, np.asarray(r), atol=1e-3, rtol=1e-3)
    wav, n = ts.synthesize_full(src, pun, style)
    assert n == wav.shape[1] == len(chunks) * 16 * CFG.hop_size
    full = synthesize(pt, CFG, src, pun, style, device="cpu")
    covered = int(full.mel_len[0]) * CFG.hop_size
    assert n >= covered > 0 and n - covered < 16 * CFG.hop_size   # no chunk past mel_len
    np.testing.assert_allclose(wav[:, :covered], full.wav[:, :covered].numpy(), **FULL)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_stream_dispatch_ahead_bit_identical(rng, model, precision):
    """Every `ahead` window yields the same bytes, in f32 and in the bf16
    serving dtype; a batch of two streams row by row."""
    _, pt = model
    cfg = CFG.replace(compute_dtype=precision)
    src, pun, style = _utterance(rng, B=2)
    outs = []
    for ahead in (None, 1, 2, 4):
        s = StreamingSynthesizer(pt, cfg, chunk_frames=16, overlap=8, ahead=ahead, device="cpu")
        outs.append(np.concatenate(list(s.stream(src, pun, style)), axis=1))
    assert outs[0].shape[0] == 2 and outs[0].dtype == np.float32
    assert np.isfinite(outs[0]).all() and np.abs(outs[0]).max() <= 1.0
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    if precision == "bfloat16":
        assert s.params["vocoder"]["input_conv_w"].dtype == torch.bfloat16
        one = np.concatenate(list(s.stream(src[:1], pun[:1], style[:1])), axis=1)
        np.testing.assert_allclose(one[0], outs[0][0, :one.shape[1]], rtol=0, atol=2 * 2.0 ** -8)


def test_nondividing_chunk_default_geometry(rng):
    """The production default's shape class (chunk 64 with a max_seq_len it
    does not divide): T=96 gives chunks of 64 and 32, the short tail is
    emitted exactly, and set_params swaps the weights."""
    cfg = CFG.replace(max_seq_len=96)
    pt = tparams.init_params(cfg, seed=0, device="cpu")
    mel = torch.from_numpy(rng.normal(size=(1, 96, cfg.num_mels)).astype(np.float32))
    full = hifigan.vocode(pt, cfg, mel).numpy()
    s = StreamingSynthesizer(pt, cfg, chunk_frames=64, overlap=8, device="cpu")
    out = torch.cat(list(s.vocode_chunks(mel, 2)), dim=1).numpy()
    assert out.shape == full.shape
    np.testing.assert_allclose(out, full, **FULL)
    with pytest.raises(ValueError):
        s.program(80, 0, 64)(s._model, mel[:, :72])         # a window of another length
    other = tparams.init_params(cfg, seed=1, device="cpu")
    s.set_params(other)
    swapped = torch.cat(list(s.vocode_chunks(mel, 2)), dim=1).numpy()
    np.testing.assert_allclose(swapped, hifigan.vocode(other, cfg, mel).numpy(), **FULL)
    assert np.abs(swapped - out).max() > 1e-3


def test_streaming_wav_sink_incremental(tmp_path, rng, model):
    """Chunk 0's bytes are on disk before later chunks are computed, and the
    finished file is a valid WAV equal to the concatenated stream."""
    _, pt = model
    src, pun, style = _utterance(rng)
    s = StreamingSynthesizer(pt, CFG, chunk_frames=16, overlap=8, device="cpu")
    path = str(tmp_path / "stream.wav")
    sizes, chunks = [], []
    with StreamingWavWriter(path, CFG.sampling_rate) as sink:
        for chunk in s.stream(src, pun, style):
            sink.write(chunk)
            sizes.append(os.path.getsize(path))
            chunks.append(chunk)
        assert sink.samples_written == sum(c.shape[1] for c in chunks)
    assert len(chunks) >= 2
    assert sizes[0] == 44 + chunks[0].shape[1] * 2
    assert all(b > a for a, b in zip(sizes, sizes[1:]))
    got, rate = read_wav(path)
    assert rate == CFG.sampling_rate
    ref = np.concatenate(chunks, axis=1)[0]
    np.testing.assert_allclose(got, np.clip(ref, -1, 1), atol=1.0 / 32000)
    sink.close()                                             # closing twice is harmless
    with pytest.raises(ValueError):
        StreamingWavWriter(str(tmp_path / "x.wav"), 24000).write(np.zeros((2, 4)))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cli_stream_nondividing_chunks(tmp_path, capsys, model, precision):
    """--stream --demo with a chunk size that does not divide max_seq_len
    writes a valid streamed WAV and prints the TTFA line to stderr; in f32
    the file equals the JAX CLI's to 1 LSB of PCM16."""
    import zerovox_tpu.cli as jcli
    from zerovox_tpu.io.wav import read_wav as j_read_wav
    pj, _ = model
    ckpt = str(tmp_path / "m.gguf")
    jparams.save_params(ckpt, pj, J_TINY)
    out = str(tmp_path / "out.wav")
    assert CFG.max_seq_len % 24 != 0
    flags = ["--model", ckpt, "--demo", "--stream", "--chunk-frames", "24"]
    assert tcli.main(flags + ["--output", out, "--device", "cpu", "--precision", precision]) == 0
    err = capsys.readouterr().err
    assert "TTFA" in err and "samples on disk" in err
    wav, rate = read_wav(out)
    assert rate == CFG.sampling_rate and len(wav) > 0 and len(wav) % (24 * CFG.hop_size) == 0
    if precision == "float32":
        jout = str(tmp_path / "j.wav")
        assert jcli.main(flags + ["--output", jout]) == 0
        ref, _ = j_read_wav(jout)
        assert ref.shape == wav.shape
        assert np.abs(np.round(ref * 32767) - np.round(wav * 32767)).max() <= 1


def test_stream_pcm16_matches_host_quantisation(rng, model):
    """pcm16=True (chunks quantised where they were computed) equals
    quantising the float chunks on the host, chunk for chunk, and the
    engine's quantiser is the same function."""
    _, pt = model
    src, pun, style = _utterance(rng)
    sf = StreamingSynthesizer(pt, CFG, chunk_frames=16, overlap=8, device="cpu")
    sq = StreamingSynthesizer(pt, CFG, chunk_frames=16, overlap=8, pcm16=True, device="cpu")
    floats = list(sf.stream(src, pun, style))
    quants = list(sq.stream(src, pun, style))
    assert len(floats) == len(quants) and quants[0].dtype == np.int16
    for f, q in zip(floats, quants):
        np.testing.assert_array_equal(q, float_to_pcm16(f))
    x = np.clip(rng.normal(scale=0.7, size=4000), -1.3, 1.3).astype(np.float32)
    np.testing.assert_array_equal(float_to_pcm16_device(torch.from_numpy(x)).numpy(),
                                  float_to_pcm16(x))
    np.testing.assert_array_equal(
        float_to_pcm16_device(torch.from_numpy(x).to(torch.bfloat16)).numpy(),
        float_to_pcm16(torch.from_numpy(x).to(torch.bfloat16).float().numpy()))
