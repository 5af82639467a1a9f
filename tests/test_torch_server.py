"""The port's serving daemon against the JAX package's, on the CPU.

Both daemons run in-process on port 0 with the same weights (TINY config,
zerovox_tpu.params.init_params carried across); the same request bodies go
to both.  PCM16 answers agree within 2 LSB (the f32 pipeline parity of
docs/ARCHITECTURE.md section 10, wav atol 1e-3, at int16 scale is far wider;
2 LSB is what a quantisation boundary plus a last-ulp float difference
gives), with equal lengths and mel_len; bad requests get the same status
code and an `error` key from both; /healthz, /metrics and the Prometheus
text have the same key sets.  Each package's client is run against the
other package's daemon, every method.  Every HTTP wait and thread join has
a timeout.
"""

import base64
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.runtime import server as jserver
from zerovox_tpu.runtime.client import TTSClient as JClient
from zerovox_tpu.runtime.client import TTSServerError as JServerError

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.runtime import server as tserver
from zerovox_tpu_torch.runtime import utterance as tutt
from zerovox_tpu_torch.runtime.client import TTSClient, TTSServerError, parse_wav_bytes
from zerovox_tpu_torch.runtime.engine import TTSEngine

CFG = TINY_CONFIG
LSB = 2                      # PCM16 tolerance between the two packages
TIMEOUT = 120
JSON = {"Content-Type": "application/json"}
BINARY = {"Content-Type": "application/octet-stream"}
SERVER_KW = dict(port=0, chunk_frames=16, overlap=8, max_body_bytes=64 << 10, max_batch=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """TINY-size ops gain nothing from intra-op threads, and several test
    workers' thread pools spinning on the same cores cost a lot."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY), CFG, device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def pair(weights):
    """(JAX daemon, port daemon) on the same weights.  The JAX daemon is not
    warmed: it compiles what the requests below reach, which is less."""
    pj, pt = weights
    js = jserver.TTSServer(pj, J_TINY, warmup=False, allow_reload=True, **SERVER_KW)
    ts = tserver.TTSServer(pt, CFG, warmup=True, allow_reload=True, device="cpu", **SERVER_KW)
    js.start()
    ts.start()
    yield js, ts
    js.shutdown()
    ts.shutdown()


def _utt(seed=0, n=None):
    rng = np.random.default_rng(seed)
    n = CFG.max_n_phonemes if n is None else n
    return {"phonemes": rng.integers(1, CFG.num_phonemes + 1, size=n).tolist(),
            "puncts": rng.integers(0, CFG.num_puncts + 1, size=n).tolist(),
            "style": rng.normal(scale=0.05, size=CFG.d_model).astype(np.float32).tolist()}


def _request(server, method, path, body=None, headers=JSON):
    """(status, headers, body bytes) of one request on a fresh connection."""
    c = http.client.HTTPConnection(*server.address, timeout=TIMEOUT)
    try:
        if body is None:
            c.request(method, path)
        else:
            c.request(method, path, body, headers)
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def _pcm(body):
    wav, rate = parse_wav_bytes(body)
    assert rate == CFG.sampling_rate
    return wav.astype(np.int32)


def _close(a, b, what):
    assert a.shape == b.shape and a.size > 0, (what, a.shape, b.shape)
    assert np.abs(a - b).max() <= LSB, (what, int(np.abs(a - b).max()))


def _both(pair, method, path, body=None, headers=JSON):
    (sj, hj, bj), (st, ht, bt) = (_request(s, method, path, body, headers) for s in pair)
    assert sj == st, (path, sj, st, bj[:200], bt[:200])
    return sj, (hj, bj), (ht, bt)


# ------------------------------------------------------------------ endpoints

@pytest.mark.parametrize("path,binary", [
    ("/synthesize", False), ("/synthesize?trim=0", False), ("/synthesize", True),
    ("/synthesize?trim=0", True), ("/stream", False), ("/stream", True)])
def test_synthesize_and_stream_match_jax(pair, path, binary):
    utt = _utt(seed=3)
    body = (tutt.utterance_to_binary(utt["phonemes"], utt["style"], utt["puncts"]) if binary
            else json.dumps(utt).encode())
    status, (hj, bj), (ht, bt) = _both(pair, "POST", path, body, BINARY if binary else JSON)
    assert status == 200 and hj["Content-Type"] == ht["Content-Type"] == "audio/wav"
    if path == "/stream":
        assert hj["Transfer-Encoding"] == ht["Transfer-Encoding"] == "chunked"
        assert bj[:44] == bt[:44]                      # the streaming-WAV header
    if "trim=0" in path:
        assert len(bt) == 44 + 2 * CFG.max_seq_len * CFG.hop_size
    _close(_pcm(bj), _pcm(bt), path)


def test_json_and_binary_bodies_give_the_same_bytes(pair):
    _, ts = pair
    utt = _utt(seed=5)
    raw = tutt.utterance_to_binary(utt["phonemes"], utt["style"], utt["puncts"])
    for path in ("/synthesize", "/stream"):
        a = _request(ts, "POST", path, json.dumps(utt).encode())
        b = _request(ts, "POST", path, raw, BINARY)
        assert a[0] == b[0] == 200 and a[2] == b[2]


@pytest.mark.parametrize("path", ["/synthesize?split=1", "/stream?split=1"])
def test_split_long_matches_jax(pair, path):
    """An utterance of 2.5 windows, split at punctuation by both daemons."""
    n = CFG.max_n_phonemes * 2 + CFG.max_n_phonemes // 2
    status, (_, bj), (_, bt) = _both(pair, "POST", path, json.dumps(_utt(7, n)).encode())
    assert status == 200
    _close(_pcm(bj), _pcm(bt), path)


@pytest.mark.parametrize("trim", [1, 0])
def test_batch_matches_jax(pair, trim):
    utts = [_utt(seed=s, n=n) for s, n in ((0, 16), (1, 9), (2, 4))]
    status, (_, bj), (_, bt) = _both(pair, "POST", f"/batch?trim={trim}",
                                     json.dumps({"utterances": utts}).encode())
    dj, dt = json.loads(bj), json.loads(bt)
    assert status == 200 and set(dj) == set(dt) == {"wavs", "mel_len"}
    assert dj["mel_len"] == dt["mel_len"] and len(dt["wavs"]) == 3
    for k, (a, b) in enumerate(zip(dj["wavs"], dt["wavs"])):
        wa, wb = _pcm(base64.b64decode(a)), _pcm(base64.b64decode(b))
        _close(wa, wb, f"batch row {k}")
        assert len(wb) == (dt["mel_len"][k] if trim else CFG.max_seq_len) * CFG.hop_size


def test_stream_equals_synthesize_on_the_port(pair):
    """The port's own /stream against its /synthesize?trim=0 on the emitted
    prefix: 1 LSB, as the JAX package's test of its daemon."""
    _, ts = pair
    body = json.dumps(_utt(seed=11)).encode()
    stream = _pcm(_request(ts, "POST", "/stream", body)[2])
    full = _pcm(_request(ts, "POST", "/synthesize?trim=0", body)[2])
    assert 0 < len(stream) <= len(full)
    assert np.abs(stream - full[:len(stream)]).max() <= 1


def test_concurrent_streams_are_independent(pair):
    """Four clients stream different utterances at once from the port's
    daemon: each reassembled stream equals that utterance's own one-shot
    synthesis."""
    _, ts = pair
    utts = [json.dumps(_utt(seed=s)).encode() for s in (10, 11, 12, 13)]
    results, errors = {}, []

    def run(i):
        try:
            status, _, body = _request(ts, "POST", "/stream", utts[i])
            assert status == 200
            results[i] = _pcm(body)
        except Exception as e:          # noqa: BLE001
            errors.append((i, repr(e)))

    workers = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not errors and set(results) == set(range(4)), errors
    for i, body in enumerate(utts):
        full = _pcm(_request(ts, "POST", "/synthesize?trim=0", body)[2])
        assert np.abs(results[i] - full[:len(results[i])]).max() <= 1


# --------------------------------------------------------------- bad requests

def _long_utt(n_windows):
    utt = _utt(21, CFG.max_n_phonemes * n_windows + 1)
    utt["puncts"] = [0] * len(utt["phonemes"])
    return json.dumps(utt).encode()


def _overflow_utt():
    utt = _utt()
    utt["phonemes"][0] = 1 << 40
    return json.dumps(utt).encode()


_RAW = tutt.utterance_to_binary(_utt(5)["phonemes"], _utt(5)["style"], _utt(5)["puncts"])
_TOO_LONG = dict(_utt(), phonemes=_utt()["phonemes"] + [1], puncts=_utt()["puncts"] + [0])

BAD = {
    "empty object": ("POST", "/synthesize", b"{}", JSON, 400, "phonemes"),
    "not json": ("POST", "/synthesize", b"{]", JSON, 400, None),
    "empty body": ("POST", "/synthesize", b"", JSON, 400, "empty"),
    "style dims": ("POST", "/synthesize",
                   json.dumps({"phonemes": [1, 2, 3], "style": [0.0]}).encode(), JSON, 400, "style"),
    "too many phonemes": ("POST", "/synthesize", json.dumps(_TOO_LONG).encode(), JSON, 400,
                          "max_n_phonemes"),
    "phoneme id overflow": ("POST", "/synthesize", _overflow_utt(), JSON, 400, "malformed"),
    "body over the cap": ("POST", "/synthesize", b" " * ((64 << 10) + 1), JSON, 413, "cap"),
    "batch over the cap": ("POST", "/batch",
                           json.dumps({"utterances": [_utt(s) for s in range(5)]}).encode(),
                           JSON, 400, "cap"),
    "empty batch": ("POST", "/batch", json.dumps({"utterances": []}).encode(), JSON, 400, None),
    "split windows over the cap": ("POST", "/synthesize?split=1", _long_utt(4), JSON, 400,
                                   "windows"),
    "stream split over the cap": ("POST", "/stream?split=1", _long_utt(4), JSON, 400, "windows"),
    "split empty": ("POST", "/synthesize?split=1",
                    json.dumps(dict(_utt(), phonemes=[], puncts=[])).encode(), JSON, 400, "empty"),
    "unknown POST": ("POST", "/nope", b"{}", JSON, 404, None),
    "unknown GET": ("GET", "/nope", None, JSON, 404, None),
    "binary bad magic": ("POST", "/synthesize", b"XXXX" + _RAW[4:], BINARY, 400, "magic"),
    "binary truncated": ("POST", "/stream", _RAW[:-4], BINARY, 400, "bytes"),
    "binary trailing bytes": ("POST", "/synthesize", _RAW + b"\0\0", BINARY, 400, "bytes"),
    "reload without a path": ("POST", "/reload", b"{}", JSON, 400, "model"),
    "reload unreadable path": ("POST", "/reload", json.dumps({"model": "/nope/x.gguf"}).encode(),
                               JSON, 400, "cannot load"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_request_matches_jax(pair, case):
    method, path, body, headers, want, word = BAD[case]
    status, (_, bj), (_, bt) = _both(pair, method, path, body, headers)
    assert status == want
    ej, et = json.loads(bj)["error"], json.loads(bt)["error"]
    if word is not None:
        assert word in ej and word in et, (ej, et)


def test_reload_disabled_is_403_on_both(weights):
    pj, pt = weights
    js = jserver.TTSServer(pj, J_TINY, port=0, warmup=False)
    ts = tserver.TTSServer(pt, CFG, port=0, warmup=False, device="cpu")
    js.start()
    ts.start()
    try:
        status, (_, bj), (_, bt) = _both((js, ts), "POST", "/reload",
                                         json.dumps({"model": "/x.gguf"}).encode())
        assert status == 403
        assert "allow-reload" in json.loads(bj)["error"] and "allow-reload" in json.loads(bt)["error"]
    finally:
        js.shutdown()
        ts.shutdown()


# ------------------------------------------------------ health, metrics, text

def _keys(tree):
    """The key structure of nested dicts (lists: of their first element)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree:
        return [_keys(tree[0])]
    return None


def test_health_and_metrics_key_sets_match_jax(pair):
    for s in pair:                       # the same traffic on both first
        assert _request(s, "POST", "/synthesize", json.dumps(_utt()).encode())[0] == 200
        assert _request(s, "POST", "/synthesize", b"{}")[0] == 400
    status, (_, hj), (_, ht) = _both(pair, "GET", "/healthz")
    hj, ht = json.loads(hj), json.loads(ht)
    assert status == 200 and set(hj) == set(ht)
    for k in ("status", "sampling_rate", "max_seq_len", "precision", "mel_buckets"):
        assert hj[k] == ht[k], k
    assert "torch" in ht["platform_version"]
    status, (_, mj), (_, mt) = _both(pair, "GET", "/metrics")
    mj, mt = json.loads(mj), json.loads(mt)
    assert status == 200 and set(mj) == set(mt) == {"uptime_s", "endpoints", "device"}
    assert _keys(mj["endpoints"]["/synthesize"]) == _keys(mt["endpoints"]["/synthesize"])
    assert _keys(mj["device"]) == _keys(mt["device"])
    ep = mt["endpoints"]["/synthesize"]
    assert ep["count"] >= 2 and ep["errors"] >= 1 and ep["max_ms"] >= ep["p50_ms"] > 0
    assert mt["device"]["devices"] == [{"id": 0, "kind": "cpu", "platform": "cpu"}]


def test_prometheus_text_matches_jax(pair):
    texts = []
    for s in pair:
        status, headers, body = _request(s, "GET", "/metrics?format=prometheus")
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        texts.append(body.decode())

    def names(text, endpoint):
        rows = [ln for ln in text.splitlines() if not ln.startswith("#")]
        return {ln.split(" ")[0] for ln in rows
                if "endpoint=" not in ln or f'endpoint="{endpoint}"' in ln
                if "device=" not in ln or 'device="0"' in ln}

    assert names(texts[0], "/synthesize") == names(texts[1], "/synthesize")
    assert [ln for ln in texts[0].splitlines() if ln.startswith("#")] == \
        [ln for ln in texts[1].splitlines() if ln.startswith("#")]
    assert 'zerovox_device_up{device="0",platform="cpu"} 1' in texts[1]
    snap = {"uptime_s": 1.0, "endpoints": {}, "batcher": {"dispatches": 2, "max_batch": 3},
            "device": {"devices": [{"id": 0, "kind": "H", "platform": "gpu", "bytes_in_use": 5,
                                    "bytes_limit": 9}]}}
    assert tserver.prometheus_text(snap) == jserver.prometheus_text(snap)
    assert 'zerovox_device_bytes_in_use{device="0",platform="gpu"} 5' in tserver.prometheus_text(snap)


def test_metrics_keys_bounded(pair):
    """Unknown POST paths land in one "other" bucket on both daemons."""
    for s in pair:
        for i in range(3):
            assert _request(s, "POST", f"/scan-{i}", b"{}")[0] == 404
        m = json.loads(_request(s, "GET", "/metrics")[2])
        assert m["endpoints"]["other"]["count"] >= 3
        assert not any(k.startswith("/scan-") for k in m["endpoints"])


def test_metrics_ring_is_bounded():
    m = tserver.Metrics(window=4)
    for i in range(10):
        m.record("/synthesize", 200 if i % 2 else 500, 0.001 * (i + 1))
    snap = m.snapshot()["endpoints"]["/synthesize"]
    assert snap["count"] == 10 and snap["errors"] == 5
    assert snap["max_ms"] == 10.0 and snap["p50_ms"] >= 7.0      # the last four only
    assert len(m._ep["/synthesize"]["lat"]) == 4


# ------------------------------------------------------------------ cross-wire

def _exercise(client, error_type):
    """Every method of a TTSClient; returns the PCM it got, by name."""
    utt = _utt(seed=9)
    ph, st, pu = utt["phonemes"], utt["style"], utt["puncts"]
    out = {}
    assert client.health()["status"] == "ok"
    assert "endpoints" in client.metrics()
    out["synthesize"], rate = client.synthesize(ph, st, pu)
    assert rate == CFG.sampling_rate
    out["untrimmed"], _ = client.synthesize(ph, st, pu, trim=False)
    out["binary"], _ = client.synthesize(ph, st, pu, binary=True)
    long = _utt(seed=8, n=CFG.max_n_phonemes * 2 + 3)
    out["split"], _ = client.synthesize(long["phonemes"], long["style"], long["puncts"], split=True)
    out["stream"] = np.concatenate(list(client.stream(ph, st, pu, read_size=333)))
    out["stream binary"] = np.concatenate(list(client.stream(ph, st, pu, binary=True)))
    out["stream split"] = np.concatenate(list(client.stream(
        long["phonemes"], long["style"], long["puncts"], split=True)))
    wavs, mel_len, rate = client.batch([utt, _utt(seed=2, n=5), _utt(seed=6, n=11)])
    assert rate == CFG.sampling_rate and [len(w) for w in wavs] == [m * CFG.hop_size for m in mel_len]
    out["batch 0"], out["batch 1"], out["batch 2"] = wavs
    with pytest.raises(error_type) as ei:
        client.synthesize([1, 2, 3], [0.0])
    assert ei.value.status == 400 and "style" in ei.value.message
    with pytest.raises(error_type) as ei:
        client.reload("/nope/x.gguf")
    assert ei.value.status == 400
    with pytest.raises(ValueError, match="binary"):
        client.synthesize(ph, st, split=True, binary=True)
    return {k: np.asarray(v, np.int32) for k, v in out.items()}


def test_each_client_against_the_other_daemon(pair):
    js, ts = pair
    ours_on_jax = _exercise(TTSClient(*js.address, timeout=TIMEOUT), TTSServerError)
    theirs_on_ours = _exercise(JClient(*ts.address, timeout=TIMEOUT), JServerError)
    assert set(ours_on_jax) == set(theirs_on_ours)
    for k in ours_on_jax:
        _close(ours_on_jax[k], theirs_on_ours[k], k)
    np.testing.assert_array_equal(theirs_on_ours["binary"], theirs_on_ours["synthesize"])
    np.testing.assert_array_equal(theirs_on_ours["stream binary"], theirs_on_ours["stream"])


# --------------------------------------------------------- the binary format

def test_binary_utterance_format_matches_jax():
    utt = _utt(seed=4, n=7)
    for puncts in (utt["puncts"], None):
        raw = tutt.utterance_to_binary(utt["phonemes"], utt["style"], puncts)
        assert raw == jserver.utterance_to_binary(utt["phonemes"], utt["style"], puncts)
        assert raw[:4] == tutt.BINARY_MAGIC == jserver.BINARY_MAGIC
        assert raw[4:8] == (7).to_bytes(4, "little")             # the count, little-endian
        for a, b in zip(tutt.utterance_from_binary(raw, CFG),
                        jserver.utterance_from_binary(raw, J_TINY)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(tutt.utterance_from_binary(raw, CFG), tutt.utterance_from_dict(
            dict(utt, puncts=[0] * 7), CFG)):
        np.testing.assert_array_equal(a, b)
    too_long = tutt.utterance_to_binary([1] * (CFG.max_n_phonemes + 1), utt["style"])
    for bad in (b"", b"ZVB", b"XXXX" + raw[4:], raw[:-1], raw + b"\0", too_long):
        with pytest.raises(ValueError) as ours:
            tutt.utterance_from_binary(bad, CFG)
        with pytest.raises(ValueError) as theirs:
            jserver.utterance_from_binary(bad, J_TINY)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="equal length"):
        tutt.utterance_to_binary([1, 2], utt["style"], [0])


# ------------------------------------------------------------- the life cycle

def test_shutdown_before_serve_returns(weights):
    """shutdown() on a constructed-but-never-started server returns and
    releases the port."""
    s = tserver.TTSServer(weights[1], CFG, port=0, warmup=False, device="cpu")
    host, port = s.address
    t = threading.Thread(target=s.shutdown, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "shutdown() blocked on a never-served server"
    sock = socket.socket()
    sock.bind((host, port))
    sock.close()


def test_port_conflict_surfaces_before_device_work(weights, monkeypatch):
    """The listening socket binds first: a port conflict raises at once, and
    neither a device is resolved nor an engine constructed."""
    from zerovox_tpu_torch.runtime import engine as engine_mod
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)

    def boom(*a, **kw):
        raise AssertionError("device work before the bind failed")

    monkeypatch.setattr(engine_mod, "TTSEngine", boom)
    monkeypatch.setattr(tserver, "resolve_device", boom)
    try:
        with pytest.raises(OSError):
            tserver.TTSServer(weights[1], CFG, host="127.0.0.1", port=sock.getsockname()[1],
                              warmup=True, device="cpu")
    finally:
        sock.close()


def test_reload_hot_swaps_weights(weights, tmp_path):
    """POST /reload swaps to a new checkpoint of the same geometry: the
    audio then equals a fresh engine's on the new weights as loaded, for
    /synthesize and /stream (one reference for both); a stream that began
    before the reload ends with valid audio; another geometry gets 409 and
    the daemon goes on serving the current weights."""
    _, pt = weights
    p1 = tparams.init_params(CFG, seed=1, device="cpu")
    new_path, geo_path, shape_path = (str(tmp_path / n) for n in ("new.gguf", "geo.gguf", "shape.gguf"))
    tparams.save_params(new_path, p1, CFG)
    tparams.save_params(geo_path, p1, CFG.replace(sampling_rate=16000))
    wide = CFG.replace(vp_filter_size=CFG.vp_filter_size + 8)   # other shapes, same six fields
    tparams.save_params(shape_path, tparams.init_params(wide, seed=1, device="cpu"), wide)
    s = tserver.TTSServer(pt, CFG, port=0, warmup=False, allow_reload=True, device="cpu",
                          chunk_frames=16, overlap=8)
    s.start()
    try:
        client = TTSClient(*s.address, timeout=TIMEOUT)
        utt = _utt(seed=20)
        ph, st, pu = utt["phonemes"], utt["style"], utt["puncts"]
        before, _ = client.synthesize(ph, st, pu, trim=False)
        in_flight = client.stream(ph, st, pu)
        first = next(in_flight)
        assert s.stream._model is s.engine.model                 # weights held once
        assert client.reload(new_path) == {"status": "reloaded", "model": new_path}
        assert s.stream._model is s.engine.model
        rest = list(in_flight)
        assert len(first) > 0 and all(np.isfinite(c.astype(np.float32)).all() for c in rest)
        after, _ = client.synthesize(ph, st, pu, trim=False)
        assert not np.array_equal(after, before)
        _, loaded = tparams.load_params(new_path, device="cpu")    # conv kernels stored f16
        src, pun, sty, n = tutt.utterance_from_dict(utt, CFG)
        want, _ = TTSEngine(loaded, CFG, device="cpu").synthesize(src, pun, sty, n, trim=False,
                                                                  pcm16=True)
        np.testing.assert_array_equal(after, want[0])
        streamed = np.concatenate(list(client.stream(ph, st, pu)))
        assert np.abs(streamed.astype(np.int32) - want[0][:len(streamed)]).max() <= 1
        for path, word in ((geo_path, "restart"), (shape_path, "geometry")):
            with pytest.raises(TTSServerError) as ei:
                client.reload(path)
            assert ei.value.status == 409 and word in ei.value.message
        again, _ = client.synthesize(ph, st, pu, trim=False)
        np.testing.assert_array_equal(again, after)
    finally:
        s.shutdown()


def _gated(server):
    """Make server.engine.synthesize block until the returned gate is set;
    `entered` is set once a request is inside it."""
    gate, entered = threading.Event(), threading.Event()

    def slow(*a, **kw):
        entered.set()
        gate.wait(timeout=60)
        return [np.zeros(4, np.int16)], np.asarray([1])

    server.engine.synthesize = slow
    return gate, entered


def test_admission_control_sheds_load_503(weights):
    """max_concurrent=1 on both daemons: a second request while the first is
    in flight gets 503 + Retry-After: 1 and no body; the slot frees after."""
    pj, pt = weights
    servers = (jserver.TTSServer(pj, J_TINY, port=0, warmup=False, max_concurrent=1),
               tserver.TTSServer(pt, CFG, port=0, warmup=False, max_concurrent=1, device="cpu"))
    body = json.dumps(_utt()).encode()
    for s in servers:
        gate, entered = _gated(s)
        s.start()
        try:
            res = {}
            t = threading.Thread(
                target=lambda: res.update(status=_request(s, "POST", "/synthesize", body)[0]))
            t.start()
            assert entered.wait(timeout=30)
            status, headers, data = _request(s, "POST", "/synthesize", body)
            assert (status, headers.get("Retry-After"), data) == (503, "1", b"")
            for path in ("/stream", "/batch"):
                assert _request(s, "POST", path, body)[0] == 503
            assert _request(s, "GET", "/healthz")[0] == 200       # not under admission
            gate.set()
            t.join(timeout=TIMEOUT)
            assert not t.is_alive() and res["status"] == 200
            # the slot is released after the response is written: give it a moment
            deadline = time.time() + 10
            while (status := _request(s, "POST", "/synthesize", body)[0]) == 503 \
                    and time.time() < deadline:
                time.sleep(0.05)
            assert status == 200
            m = json.loads(_request(s, "GET", "/metrics")[2])
            assert m["endpoints"]["/synthesize"]["errors"] >= 1
        finally:
            gate.set()
            s.shutdown()


def test_unexpected_exception_yields_500(pair, capfd):
    """An unanticipated engine failure gives HTTP 500 with a generic body
    on both daemons, counts as an error, and leaves the daemon serving."""
    class Boom:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def synthesize(self, *a, **k):
            raise RuntimeError("secret detail /etc/internal (8, 64, 20)")

    for s in pair:
        orig = s.engine
        s.engine = Boom(orig)
        try:
            status, _, body = _request(s, "POST", "/synthesize", json.dumps(_utt()).encode())
        finally:
            s.engine = orig
        assert status == 500 and json.loads(body) == {"error": "internal error"}
        m = json.loads(_request(s, "GET", "/metrics")[2])
        assert m["endpoints"]["/synthesize"]["errors"] >= 1
        assert _request(s, "GET", "/healthz")[0] == 200
    assert "secret detail" in capfd.readouterr().err              # the server's log has it


def test_client_disconnect_mid_stream_is_499(pair):
    """A client that goes away while a stream is being written is recorded
    as 499 on the port's daemon and kills nothing."""
    _, ts = pair
    before = json.loads(_request(ts, "GET", "/metrics")[2])["endpoints"].get(
        "/stream", {"errors": 0})["errors"]
    inner = ts.stream.stream

    def slow_stream(*a, **kw):
        for piece in inner(*a, **kw):
            time.sleep(0.3)
            yield piece

    ts.stream.stream = slow_stream
    try:
        c = http.client.HTTPConnection(*ts.address, timeout=TIMEOUT)
        c.request("POST", "/stream", json.dumps(_utt(seed=1)).encode(), JSON)
        r = c.getresponse()
        assert r.status == 200 and len(r.read(44)) == 44
        c.sock.shutdown(socket.SHUT_RDWR)
        c.close()
        deadline = time.time() + 30
        while time.time() < deadline:
            eps = json.loads(_request(ts, "GET", "/metrics")[2])["endpoints"]
            if eps.get("/stream", {"errors": 0})["errors"] > before:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("the dropped stream was never recorded as an error")
    finally:
        del ts.stream.stream
    assert _request(ts, "POST", "/stream", json.dumps(_utt(seed=1)).encode())[0] == 200


def test_cli_serve_sigterm_graceful(weights, tmp_path):
    """--serve --device cpu in a subprocess: answers /healthz and one
    request of the module client, then drains on SIGTERM with exit code 0
    and no traceback."""
    model = tmp_path / "m.gguf"
    tparams.save_params(str(model), weights[1], CFG)
    utt_path = tmp_path / "utt.json"
    utt_path.write_text(json.dumps(_utt(seed=4)))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "zerovox_tpu_torch.cli", "--model", str(model), "--serve",
         "--port", "0", "--device", "cpu", "--batch-window-ms", "5", "--allow-reload"],
        stderr=subprocess.PIPE, text=True, cwd=root, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        port = None
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            if line.startswith("serving on http://"):
                port = int(line.split(":")[2].split()[0].rstrip("/"))
                assert "/reload" in line
                break
        assert port, "daemon never reported its address"
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/healthz")
        assert c.getresponse().status == 200
        c.close()
        out = tmp_path / "out.wav"
        one = subprocess.run(
            [sys.executable, "-m", "zerovox_tpu_torch.runtime.client", "--port", str(port),
             "--json", str(utt_path), "--out", str(out)],
            capture_output=True, text=True, timeout=120, cwd=root)
        assert one.returncode == 0 and out.stat().st_size > 44, one.stderr
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "Traceback" not in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stderr.close()
