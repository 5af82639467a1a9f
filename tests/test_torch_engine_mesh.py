"""Multi-device serving in the port, on the CPU: TTSEngine(mesh=) (pure DP),
TPServingEngine (model axis > 1), TTSServer(mesh=) and the CLI's --mesh,
held against the JAX package's on meshes of the same shape.

The port's meshes are torch.device("cpu") repeated (make_mesh(devices=...));
the JAX meshes are jax.devices()[:n] of the 8 virtual CPU devices.  Answers
are compared as PCM16 within 2 LSB, as the daemon tests compare the two
packages (tests/test_torch_server.py), with mel_len equal.  No JAX daemon
is started: the daemon's answers are held against the JAX engines, whose
compiles the module-scoped fixtures share.
"""

import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.parallel import make_mesh as j_make_mesh
from zerovox_tpu.parallel import parse_mesh_spec as j_parse_mesh_spec
from zerovox_tpu.runtime.engine import TTSEngine as JEngine
from zerovox_tpu.runtime.tp_engine import TPServingEngine as JTPEngine

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch import cli as tcli
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.io.wav import float_to_pcm16
from zerovox_tpu_torch.models import hifigan
from zerovox_tpu_torch.parallel import make_mesh
from zerovox_tpu_torch.runtime.client import parse_wav_bytes
from zerovox_tpu_torch.runtime.engine import TTSEngine
from zerovox_tpu_torch.runtime.server import TTSServer
from zerovox_tpu_torch.runtime.tp_engine import TPServingEngine

CFG = TINY_CONFIG
LSB = 2
CPU = torch.device("cpu")
BUCKETS = (16, 32)
TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY), CFG, device="cpu")
    return pj, pt


def cpu_mesh(data, model):
    return make_mesh(data=data, model=model, devices=[CPU] * (data * model))


@pytest.fixture(scope="module")
def jax_dp(weights):
    mesh = j_make_mesh(data=4, model=1, devices=jax.devices()[:4])
    return JEngine(weights[0], J_TINY, mel_buckets=BUCKETS, mesh=mesh)


@pytest.fixture(scope="module")
def jax_tp(weights):
    mesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    return JTPEngine(weights[0], J_TINY, mesh)


@pytest.fixture(scope="module")
def dp(weights):
    return TTSEngine(weights[1], CFG, mel_buckets=BUCKETS, mesh=cpu_mesh(4, 1))


@pytest.fixture(scope="module")
def tp(weights):
    return TPServingEngine(weights[1], CFG, cpu_mesh(2, 2))


def _inputs(seed, B):
    rng = np.random.default_rng(seed)
    P = CFG.max_n_phonemes
    return (rng.integers(1, CFG.num_phonemes, size=(B, P)).astype(np.int32),
            rng.integers(0, CFG.num_puncts, size=(B, P)).astype(np.int32),
            rng.normal(scale=0.1, size=(B, CFG.d_model)).astype(np.float32))


def _pcm(w):
    return float_to_pcm16(np.asarray(w, np.float32)).astype(np.int32)


def _hold(got, want):
    """(wavs, mel_len) pairs within LSB of PCM16, equal lengths and mel_len."""
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert a.shape == np.asarray(b).shape
        assert np.abs(_pcm(a) - _pcm(b)).max(initial=0) <= LSB


def test_dp_ladder_and_tp_mesh_rejected(weights, dp):
    """The ladder scales by the data size; the engine keeps the caller's
    tree unplaced; a mesh that repeats one device holds one replica; a TP
    mesh is refused."""
    assert dp.batch_ladder == tuple(4 * s for s in (1, 2, 4, 8))
    assert dp.host_params is weights[1]
    assert len({id(m) for m in dp._models}) == 1 and len(dp._models) == 4
    with pytest.raises(ValueError, match="pure-DP"):
        TTSEngine(weights[1], CFG, mesh=cpu_mesh(2, 2))


def test_dp_b1_matches_jax(dp, jax_dp):
    """A lone request pads to one row per device and answers what JAX's DP
    engine answers; single_rtt on and off agree."""
    src, pun, style = _inputs(0, 1)
    want = jax_dp.synthesize(src, pun, style)
    _hold(dp.synthesize(src, pun, style), want)
    _hold(dp.synthesize(src, pun, style, single_rtt=True), want)


def test_dp_packed_mixed_batch_matches_jax(dp, jax_dp):
    """A mixed-length B=5 batch through synthesize_packed: its bucket groups
    pad to the mesh-scaled ladder and answer as JAX's DP engine does."""
    src, pun, style = _inputs(1, 5)
    P = CFG.max_n_phonemes
    nph = np.array([2, 2, P, 2, P], np.int32)
    _hold(dp.synthesize_packed(src, pun, style, num_phonemes=nph),
          jax_dp.synthesize_packed(src, pun, style, num_phonemes=nph))


def test_dp_warmup_covers_mesh_ladder(dp, monkeypatch):
    """warm-up at the ladder top runs every (per-device batch, bucket) a
    request can vocode at, on every data device's slice: a later packed
    batch of a non-ladder size vocodes no new shape."""
    shapes = set()
    vocode = hifigan.vocode

    def recording(params, cfg, mel, *a, **kw):
        shapes.add(tuple(mel.shape))
        return vocode(params, cfg, mel, *a, **kw)

    monkeypatch.setattr(hifigan, "vocode", recording)
    dp.warmup(batch=dp.batch_ladder[-1], pcm16=True)
    warmed = set(shapes)
    assert {s[0] for s in warmed} == {1, 2, 4, 8}          # per-device rows of each rung
    assert {s[1] for s in warmed} == set(dp.mel_buckets)
    src, pun, style = _inputs(2, dp.batch_ladder[0] + 1)
    dp.synthesize_packed(src, pun, style)
    dp.synthesize_async(src, pun, style, pcm16=True)()
    assert shapes == warmed


def test_dp_reload_replaces_every_replica(weights):
    """reload_params swaps the weights of every data device at once, as one
    reference; the answers then equal a fresh engine's on the new weights;
    another geometry is refused."""
    p1 = tparams.init_params(CFG, seed=1, device="cpu")
    engine = TTSEngine(weights[1], CFG, mel_buckets=BUCKETS, mesh=cpu_mesh(2, 1))
    old = engine._models
    engine.reload_params(p1)
    assert engine._models is not old and engine.host_params is p1
    src, pun, style = _inputs(3, 2)
    fresh = TTSEngine(p1, CFG, mel_buckets=BUCKETS, device="cpu")
    _hold(engine.synthesize(src, pun, style), fresh.synthesize(src, pun, style))
    with pytest.raises(ValueError, match="geometry"):
        engine.reload_params(tparams.init_params(CFG.replace(hifigan_channels=64), seed=0,
                                                 device="cpu"))


def test_tp_engine_rejects_and_ladder(weights, tp):
    with pytest.raises(ValueError, match="model axis"):
        TPServingEngine(weights[1], CFG, cpu_mesh(4, 1))
    assert tp.batch_ladder == tuple(2 * s for s in (1, 2, 4, 8))
    assert tp.mel_buckets == (CFG.max_seq_len,)


def test_tp_engine_matches_jax(tp, jax_tp):
    """B=1 (padded to one row per data row) and a non-ladder B=3 answer as
    JAX's TP engine on a (2, 2) mesh; the packed path and the batcher's
    dispatch / fetch split answer as the direct call, float and PCM16."""
    for B in (1, 3):
        src, pun, style = _inputs(4 + B, B)
        got = tp.synthesize(src, pun, style)
        _hold(got, jax_tp.synthesize(src, pun, style))
        _hold(tp.synthesize_packed(src, pun, style), got)
        _hold(tp.synthesize_async(src, pun, style)(), got)
        wavs, lens = tp.synthesize_async(src, pun, style, pcm16=True)()
        assert wavs[0].dtype == np.int16
        for a, b in zip(wavs, got[0]):
            assert np.abs(a.astype(np.int32) - _pcm(b)).max(initial=0) <= 1


def test_tp_engine_warmup_and_reload(weights):
    """warm-up runs every ladder size; reload_params keeps each leaf's split
    (the same shapes on the same devices) and answers as a fresh TP engine
    on the new weights; another geometry is refused."""
    engine = TPServingEngine(weights[1], CFG, cpu_mesh(1, 2), batch_ladder=(1, 2))
    engine.warmup(batch=2, pcm16=True)
    old = engine.params
    p1 = tparams.init_params(CFG, seed=1, device="cpu")
    engine.reload_params(p1)
    for (idx, a), b in zip(np.ndenumerate(old), engine.params.flat):
        assert a.device == b.device
        assert tparams.tree_map(lambda x, y: x.shape == y.shape and x.device == y.device,
                                a.params, b.params) == tparams.tree_map(lambda x: True, a.params)
    src, pun, style = _inputs(9, 2)
    _hold(engine.synthesize(src, pun, style),
          TPServingEngine(p1, CFG, cpu_mesh(1, 2)).synthesize(src, pun, style))
    with pytest.raises(ValueError, match="geometry"):
        engine.reload_params(tparams.init_params(CFG.replace(hifigan_channels=64), seed=0,
                                                 device="cpu"))


def _utt(seed):
    rng = np.random.default_rng(seed)
    P = CFG.max_n_phonemes
    return {"phonemes": rng.integers(1, CFG.num_phonemes, size=P).tolist(),
            "puncts": rng.integers(0, CFG.num_puncts, size=P).tolist(),
            "style": rng.normal(scale=0.05, size=CFG.d_model).astype(np.float32).tolist()}


def _post(server, path, utt):
    c = http.client.HTTPConnection(*server.address, timeout=TIMEOUT)
    try:
        c.request("POST", path, json.dumps(utt).encode(), {"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _concurrently(fn, n):
    results, barrier = [None] * n, threading.Barrier(n)

    def worker(i):
        barrier.wait(timeout=TIMEOUT)
        results[i] = fn(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    return results


def _want(engine, utt):
    """The JAX engine's answer to one utterance as int32 PCM16."""
    wavs, _ = engine.synthesize(np.asarray([utt["phonemes"]], np.int32),
                                np.asarray([utt["puncts"]], np.int32),
                                np.asarray([utt["style"]], np.float32))
    return _pcm(wavs[0])


def test_server_on_dp_mesh_streams_rotate_and_batch(weights, jax_dp, monkeypatch):
    """A daemon on a (2, 1) mesh with the batcher on: two concurrent
    /stream sessions rotate over the mesh's devices and answer the same
    audio; three concurrent /synthesize requests share batched calls; every
    answer within 2 LSB of JAX's DP engine."""
    s = TTSServer(weights[1], CFG, port=0, chunk_frames=16, overlap=8, mel_buckets=BUCKETS,
                  batch_window_ms=50.0, mesh=cpu_mesh(2, 1))
    s.start()
    try:
        assert s.stream.devices == [CPU, CPU] and s.engine.batch_ladder[0] == 2
        sessions = []
        rotate = s.stream.session_device
        monkeypatch.setattr(s.stream, "session_device",
                            lambda device=None: sessions.append(rotate(device)) or sessions[-1])
        utt = _utt(3)
        want = _want(jax_dp, utt)
        streams = _concurrently(lambda i: _post(s, "/stream", utt), 2)
        assert sessions == [CPU, CPU] and next(s.stream._rr) % 2 == 0   # one session each
        for status, raw in streams:
            assert status == 200
            pcm = np.frombuffer(raw[44:], dtype=np.int16).astype(np.int32)
            assert pcm.shape == want.shape and np.abs(pcm - want).max(initial=0) <= LSB
        np.testing.assert_array_equal(streams[0][1], streams[1][1])
        utts = [_utt(10 + i) for i in range(3)]
        answers = _concurrently(lambda i: _post(s, "/synthesize", utts[i]), 3)
        for (status, raw), u in zip(answers, utts):
            assert status == 200
            got, rate = parse_wav_bytes(raw)
            want = _want(jax_dp, u)
            assert got.shape == want.shape and np.abs(got.astype(np.int32) - want).max(
                initial=0) <= LSB
        assert s.batcher.snapshot()["requests"] == 3
    finally:
        s.shutdown()


def test_server_on_tp_mesh(weights, jax_tp):
    """A daemon on a (1, 2) mesh serves through TPServingEngine (/synthesize
    and /stream, the stream on the mesh's first device) within 2 LSB of
    JAX's TP engine."""
    s = TTSServer(weights[1], CFG, port=0, chunk_frames=16, overlap=8, mesh=cpu_mesh(1, 2))
    s.start()
    try:
        assert isinstance(s.engine, TPServingEngine) and s.stream.devices is None
        utt = _utt(5)
        want = _want(jax_tp, utt)
        for path in ("/synthesize", "/stream"):
            status, raw = _post(s, path, utt)
            assert status == 200
            got = (parse_wav_bytes(raw)[0] if path == "/synthesize"
                   else np.frombuffer(raw[44:], dtype=np.int16)).astype(np.int32)
            assert got.shape == want.shape and np.abs(got - want).max(initial=0) <= LSB
    finally:
        s.shutdown()


def test_cli_mesh_flag(tmp_path, weights, capsys):
    """--mesh DATA,MODEL with --serve: a malformed spec exits 2 with the JAX
    package's message; --mesh with --device cpu is refused (the mesh spans
    CUDA devices, and the repeated-device mesh is only the library's)."""
    ckpt = str(tmp_path / "m.gguf")
    tparams.save_params(ckpt, weights[1], CFG)
    for spec in ("2", "0,1", "a,b"):
        with pytest.raises(ValueError) as want:
            j_parse_mesh_spec(spec)
        with pytest.raises(SystemExit) as e:
            tcli.main(["--model", ckpt, "--serve", "--port", "0", "--device", "cpu",
                       "--mesh", spec])
        assert e.value.code == 2 and str(want.value) in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        tcli.main(["--model", ckpt, "--serve", "--port", "0", "--device", "cpu",
                   "--mesh", "2,1"])
    assert e.value.code == 2 and "CUDA devices" in capsys.readouterr().err


def test_stream_session_rotation_and_replicas(weights, monkeypatch):
    """StreamingSynthesizer(devices=...): sessions rotate over the devices
    (an explicit device pins one); a device other than the synthesizer's
    own gets a replica of the whole model at its first use, kept until
    set_params drops it; a replica made while a reload swapped the weights
    is not kept; a session pinned to its own device streams what the
    synthesizer without devices streams."""
    from zerovox_tpu_torch.models import pipeline, streaming
    meta = torch.device("meta")
    s = streaming.StreamingSynthesizer(weights[1], CFG, chunk_frames=16, overlap=8,
                                       device="cpu", devices=["cpu", "meta", "cpu"])
    assert [s.session_device() for _ in range(4)] == [CPU, meta, CPU, CPU]
    assert s.session_device("meta") == meta
    assert s.params_for(None) is s.params_for(CPU) is s._model
    rep = s.params_for(meta)
    assert rep is s.params_for(meta) and rep.device == meta
    assert rep.params["vocoder"]["input_conv_w"].device == meta
    p1 = tparams.init_params(CFG, seed=1, device="cpu")
    s.set_params(p1)
    assert s.params_for(meta) is not rep
    assert s.params["vocoder"]["input_conv_w"] is p1["vocoder"]["input_conv_w"]
    replicate = pipeline.replicate_model

    def racing(model, cfg, device):
        out = replicate(model, cfg, device)
        s.set_params(weights[1])                 # a reload lands meanwhile
        return out

    s.set_params(p1)
    monkeypatch.setattr(streaming, "replicate_model", racing)
    stale = s.params_for(meta)
    assert stale.device == meta and s._replicas == {}
    monkeypatch.undo()
    src, pun, style = _inputs(20, 1)
    plain = streaming.StreamingSynthesizer(weights[1], CFG, chunk_frames=16, overlap=8,
                                           device="cpu")
    np.testing.assert_array_equal(np.concatenate(list(s.stream(src, pun, style, device="cpu")), 1),
                                  np.concatenate(list(plain.stream(src, pun, style)), 1))
