"""The port's TTSClient against a live daemon of the port (TINY config, CPU).

The counterpart of tests/test_client.py: every endpoint through the client's
decoding paths (complete-WAV parse, chunked-stream reassembly with odd-byte
carry, base64 batch), the error mapping (HTTP 4xx -> TTSServerError), the
503 retry on a stub server, and the module CLI.  The client against the JAX
package's daemon is in tests/test_torch_server.py.
"""

import http.server
import json
import struct
import threading

import numpy as np
import pytest
import torch

import zerovox_tpu_torch as zt
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.io.wav import _wav_header, read_wav
from zerovox_tpu_torch.runtime.client import (TTSClient, TTSServerError, _main,
                                              parse_wav_bytes, utterance)
from zerovox_tpu_torch.runtime.longform import split_points
from zerovox_tpu_torch.runtime.server import TTSServer

CFG = TINY_CONFIG


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """TINY-size ops gain nothing from intra-op threads, and several test
    workers' thread pools spinning on the same cores cost a lot."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server():
    s = TTSServer(zt.init_params(CFG, seed=0, device="cpu"), CFG, port=0, warmup=True,
                  chunk_frames=16, overlap=8, max_body_bytes=64 << 10, max_batch=4, device="cpu")
    s.start()
    yield s
    s.shutdown()


@pytest.fixture(scope="module")
def client(server):
    return TTSClient(*server.address, timeout=120)


def _utt(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, CFG.num_phonemes + 1, size=CFG.max_n_phonemes).tolist(),
            rng.normal(scale=0.05, size=CFG.d_model).astype(np.float32).tolist(),
            rng.integers(0, CFG.num_puncts + 1, size=CFG.max_n_phonemes).tolist())


def test_package_exports_the_daemon():
    assert zt.TTSServer is TTSServer and zt.TTSClient is TTSClient
    assert zt.DynamicBatcher.__module__ == "zerovox_tpu_torch.runtime.batcher"


def test_health_and_metrics(client):
    h = client.health()
    assert h["status"] == "ok" and h["sampling_rate"] == CFG.sampling_rate
    assert h["precision"] == "float32" and h["mel_buckets"] == [CFG.max_seq_len]
    m = client.metrics()
    assert "endpoints" in m and "uptime_s" in m and "batcher" not in m


def test_synthesize_untrimmed_full_buffer(client):
    ph, st, pu = _utt()
    wav, sr = client.synthesize(ph, st, pu, trim=False)
    assert sr == CFG.sampling_rate and wav.dtype == np.int16
    assert len(wav) == CFG.max_seq_len * CFG.hop_size and np.any(wav != 0)
    trimmed, _ = client.synthesize(ph, st, pu)
    assert 0 < len(trimmed) < len(wav)
    np.testing.assert_array_equal(trimmed, wav[:len(trimmed)])


def test_stream_chunks_match_oneshot(client):
    ph, st, pu = _utt(seed=1)
    # a tiny read_size forces many reads, odd-byte carries across chunk
    # boundaries included: the reassembled PCM must still be exact
    chunks = list(client.stream(ph, st, pu, read_size=333))
    assert len(chunks) >= 2 and all(c.dtype == np.int16 for c in chunks)
    stream_pcm = np.concatenate(chunks)
    np.testing.assert_array_equal(stream_pcm, np.concatenate(list(client.stream(ph, st, pu))))
    full, _ = client.synthesize(ph, st, pu, trim=False)
    np.testing.assert_allclose(stream_pcm, full[:len(stream_pcm)], atol=1)


def test_batch_roundtrip(client):
    utts = [utterance(*_utt(seed=s)) for s in (2, 3)]
    wavs, mel_len, sr = client.batch(utts, trim=True)
    assert sr == CFG.sampling_rate and len(wavs) == len(mel_len) == 2
    for w, m in zip(wavs, mel_len):
        assert w.dtype == np.int16 and len(w) == m * CFG.hop_size
    solo, _ = client.synthesize(*_utt(seed=2), trim=True)
    np.testing.assert_allclose(wavs[0], solo, atol=1)


def test_split_long_form(client):
    rng = np.random.default_rng(5)
    n = CFG.max_n_phonemes * 3 - 2
    ph = rng.integers(1, CFG.num_phonemes + 1, size=n).tolist()
    pu = [0] * n
    pu[CFG.max_n_phonemes - 4] = 1                     # a boundary before the hard cap
    st = _utt()[1]
    wav, _ = client.synthesize(ph, st, pu, split=True)
    ends = split_points(pu, n, CFG.max_n_phonemes)
    assert ends == [13, 29, 45, 46]
    parts = [client.synthesize(ph[a:b], st, pu[a:b])[0] for a, b in zip([0] + ends, ends)]
    np.testing.assert_allclose(wav, np.concatenate(parts), atol=1)
    streamed = np.concatenate(list(client.stream(ph, st, pu, split=True)))
    assert len(streamed) >= len(wav) > 0


def test_error_mapping(client):
    with pytest.raises(TTSServerError) as ei:
        client.synthesize([1, 2, 3], [0.0])            # style dim mismatch
    assert ei.value.status == 400 and "style" in ei.value.message
    with pytest.raises(TTSServerError) as ei:
        client.synthesize([1] * (CFG.max_n_phonemes + 1), [0.0] * CFG.d_model)
    assert ei.value.status == 400
    with pytest.raises(TTSServerError) as ei:
        list(client.stream([1, 2, 3], [0.0]))
    assert ei.value.status == 400
    with pytest.raises(TTSServerError) as ei:
        client.reload("/x.gguf")                        # not started with allow_reload
    assert ei.value.status == 403 and "allow-reload" in str(ei.value)
    with pytest.raises(ValueError, match="binary"):
        list(client.stream([1], [0.0], split=True, binary=True))


def test_parse_wav_bytes():
    pcm = np.arange(-3, 4, dtype="<i2")
    for size in (2 * len(pcm), 0xFFFFFFFF - 44):        # exact and streaming headers
        wav, rate = parse_wav_bytes(_wav_header(22050, size) + pcm.tobytes())
        np.testing.assert_array_equal(wav, pcm)
        assert rate == 22050
    stereo = bytearray(_wav_header(22050, 4) + b"\0" * 4)
    stereo[22:24] = struct.pack("<H", 2)
    for bad in (b"not a wav" * 10, b"RIFF", bytes(stereo)):
        with pytest.raises(ValueError):
            parse_wav_bytes(bad)


class _SheddingStub:
    """A minimal HTTP stub that answers 503 + Retry-After n times, then 200:
    the client's admission-control retry without racing a real daemon into
    overload."""

    def __init__(self, shed_first_n: int):
        stub = self

        class H(http.server.BaseHTTPRequestHandler):
            def _respond(self):
                stub.hits += 1
                if stub.hits <= shed_first_n:
                    body = b'{"error": "server overloaded"}'
                    self.send_response(503)
                    self.send_header("Retry-After", "0.05")
                elif self.path.startswith("/stream"):
                    body = _wav_header(22050, 16) + np.arange(8, dtype="<i2").tobytes()
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                else:
                    body = json.dumps({"status": "ok"}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = _respond

            def log_message(self, *a):
                pass

        self.hits = 0
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


@pytest.mark.parametrize("shed,retries,hits,status", [
    (2, 3, 3, None),          # 2 sheds + 1 success
    (100, 1, 2, 503),         # first try + 1 retry, then raises
    (1, 0, 1, 503),           # retries disabled
])
def test_client_503_retry(shed, retries, hits, status):
    stub = _SheddingStub(shed_first_n=shed)
    try:
        c = TTSClient("127.0.0.1", stub.port, timeout=10, retries_503=retries)
        if status is None:
            assert c.health()["status"] == "ok"
        else:
            with pytest.raises(TTSServerError) as ei:
                c.health()
            assert ei.value.status == status and "overloaded" in ei.value.message
        assert stub.hits == hits
    finally:
        stub.close()


def test_client_stream_retries_503():
    stub = _SheddingStub(shed_first_n=1)
    try:
        c = TTSClient("127.0.0.1", stub.port, timeout=10, retries_503=2)
        pcm = np.concatenate(list(c.stream([1], [0.0])))
        np.testing.assert_array_equal(pcm, np.arange(8, dtype=np.int16))
        assert stub.hits == 2          # 1 shed + 1 success
    finally:
        stub.close()


def test_module_cli_oneshot_and_stream(server, tmp_path, capsys):
    ph, st, pu = _utt(seed=4)
    utt_path = tmp_path / "utt.json"
    utt_path.write_text(json.dumps({"phonemes": ph, "style": st, "puncts": pu}))
    host, port = server.address
    base = ["--host", host, "--port", str(port), "--json", str(utt_path)]
    out = tmp_path / "one.wav"
    assert _main(base + ["--out", str(out), "--no-trim"]) == 0
    wav, sr = read_wav(str(out))
    assert sr == CFG.sampling_rate and len(wav) == CFG.max_seq_len * CFG.hop_size
    out2 = tmp_path / "stream.wav"
    assert _main(base + ["--out", str(out2), "--stream"]) == 0
    assert "first chunk after" in capsys.readouterr().out
    wav2, _ = read_wav(str(out2))
    assert len(wav2) > 0
    np.testing.assert_allclose(wav2, wav[:len(wav2)], atol=2.0 / 32767.0)
    out3 = tmp_path / "split.wav"
    assert _main(base + ["--out", str(out3), "--split"]) == 0
    assert len(read_wav(str(out3))[0]) > 0
