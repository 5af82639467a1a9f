"""Python client for the zerovox serving daemon (runtime/server.py).

The port of zerovox_tpu/runtime/client.py: a stdlib-only (http.client +
numpy) programmatic interface to every endpoint, over the same wire format,
so it talks to either package's daemon.  It keeps the daemon's latency
properties: `stream()` yields PCM16 chunks the moment they arrive on the
socket, so a caller's time to first audio is the stream's, not the
utterance's length.

    from zerovox_tpu_torch.runtime.client import TTSClient
    c = TTSClient(port=8765)
    wav, sr = c.synthesize(phonemes, style)          # int16 ndarray
    for chunk in c.stream(phonemes, style):          # int16 chunks
        player.feed(chunk)

Also runnable as a module for smoke checks against a live daemon:

    python -m zerovox_tpu_torch.runtime.client --port 8765 --json utt.json \
        --out out.wav [--stream] [--split]
"""

from __future__ import annotations

import http.client
import json
import struct
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .utterance import utterance_to_binary

_JSON_HDRS = {"Content-Type": "application/json"}


class TTSServerError(RuntimeError):
    """Non-2xx response from the daemon (carries .status and .message)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


def _retry_after_s(r: http.client.HTTPResponse) -> float:
    """Clamped sleep interval from a 503's Retry-After header."""
    try:
        delay = float(r.getheader("Retry-After") or 1.0)
    except (TypeError, ValueError):
        delay = 1.0
    return max(0.05, min(delay, 30.0))


def _utterance_body(phonemes: Sequence[int], style: Sequence[float],
                    puncts: Optional[Sequence[int]] = None) -> dict:
    """Build the daemon's utterance JSON schema (server.py docstring)."""
    d = {"phonemes": np.asarray(phonemes, dtype=np.int32).tolist(),
         "style": np.asarray(style, dtype=np.float32).ravel().tolist()}
    if puncts is not None:
        d["puncts"] = np.asarray(puncts, dtype=np.int32).tolist()
    return d


def parse_wav_bytes(body: bytes) -> Tuple[np.ndarray, int]:
    """Decode a complete PCM16 mono RIFF body -> (int16 samples, rate).

    Accepts both exact-size headers (/synthesize) and the streaming-WAV
    0xFFFFFFFF convention (/stream): data extent = whatever follows the
    44-byte canonical header.
    """
    if len(body) < 44 or body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE body")
    fmt, ch, rate, _, _, bits = struct.unpack("<HHIIHH", body[20:36])
    if fmt != 1 or ch != 1 or bits != 16:
        raise ValueError("only PCM16 mono supported")
    n = (len(body) - 44) // 2
    return np.frombuffer(body, dtype="<i2", count=n, offset=44), rate


class TTSClient:
    """Client for one daemon; opens a fresh connection per request.

    Per-request connections keep the object trivially thread-safe and
    immune to server-side keep-alive races; setting up a loopback TCP
    connection is small against synthesis time.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 timeout: float = 300.0, retries_503: int = 3):
        """retries_503: how many times to honor a 503 + Retry-After from
        the daemon's admission control (load shedding) before raising.
        0 disables retrying."""
        self.host, self.port, self.timeout = host, int(port), float(timeout)
        self.retries_503 = int(retries_503)

    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 raw: Optional[bytes] = None) -> bytes:
        if raw is not None:
            payload, hdrs = raw, {"Content-Type": "application/octet-stream"}
        else:
            payload = None if body is None else json.dumps(body).encode()
            hdrs = _JSON_HDRS if payload is not None else {}
        for attempt in range(self.retries_503 + 1):
            c = self._connect()
            try:
                c.request(method, path, payload, hdrs)
                r = c.getresponse()
                data = r.read()
                if r.status == 503 and attempt < self.retries_503:
                    # daemon shed the request (--max-concurrent); wait the
                    # advertised interval and retry
                    time.sleep(_retry_after_s(r))
                    continue
                if r.status >= 300:
                    raise TTSServerError(r.status, _error_text(data))
                return data
            finally:
                c.close()
        raise AssertionError("unreachable")

    # -- introspection ----------------------------------------------------

    def health(self) -> dict:
        """GET /healthz -> dict (raises if the daemon is unhealthy)."""
        return json.loads(self._request("GET", "/healthz"))

    def metrics(self) -> dict:
        """GET /metrics -> per-endpoint counters and latency quantiles."""
        return json.loads(self._request("GET", "/metrics"))

    def reload(self, model_path: str) -> dict:
        """POST /reload -> hot-swap daemon weights from a new GGUF.

        Requires the daemon to run with --allow-reload (403 otherwise);
        geometry changes are rejected with 409."""
        return json.loads(self._request("POST", "/reload",
                                        {"model": model_path}))

    # -- synthesis --------------------------------------------------------

    def synthesize(self, phonemes: Sequence[int], style: Sequence[float],
                   puncts: Optional[Sequence[int]] = None, *,
                   trim: bool = True, split: bool = False,
                   binary: bool = False) -> Tuple[np.ndarray, int]:
        """POST /synthesize -> (int16 samples, sampling_rate).

        split=True engages the daemon's long-form mode: utterances of any
        length, punctuation-split server-side (implies trim).
        binary=True sends the raw-binary utterance body
        (application/octet-stream; utterance.utterance_to_binary layout)
        instead of JSON — the latency fast path (not valid with split,
        which needs the unbounded-length JSON schema).
        """
        path = "/synthesize?trim=%d" % int(trim)
        if split:
            if binary:
                raise ValueError("binary=True is incompatible with "
                                 "split=True (long-form uses JSON)")
            path += "&split=1"
        if binary:
            body = self._request("POST", path, raw=utterance_to_binary(
                phonemes, style, puncts))
        else:
            body = self._request("POST", path,
                                 _utterance_body(phonemes, style, puncts))
        return parse_wav_bytes(body)

    def batch(self, utterances: Sequence[dict], *, trim: bool = True
              ) -> Tuple[List[np.ndarray], List[int], int]:
        """POST /batch -> (list of int16 sample arrays, mel lengths, rate).

        `utterances` are schema dicts — build them with `utterance()`.
        One bucket-packed device dispatch serves the whole list.
        """
        import base64
        data = json.loads(self._request(
            "POST", "/batch?trim=%d" % int(trim), {"utterances": list(utterances)}))
        wavs, rate = [], 0
        for b64 in data["wavs"]:
            w, rate = parse_wav_bytes(base64.b64decode(b64))
            wavs.append(w)
        return wavs, data["mel_len"], rate

    def stream(self, phonemes: Sequence[int], style: Sequence[float],
               puncts: Optional[Sequence[int]] = None, *,
               split: bool = False, read_size: int = 1 << 15,
               binary: bool = False) -> Iterator[np.ndarray]:
        """POST /stream -> iterator of int16 PCM chunks as they arrive.

        http.client decodes the chunked framing; reading `read_size` bytes
        at a time returns data the moment the daemon flushes it, so the
        first yield lands at the engine's TTFA.  An odd trailing byte
        (PCM16 spans two reads) is carried into the next chunk.
        binary=True sends the raw-binary utterance body (see synthesize).
        """
        path = "/stream" + ("?split=1" if split else "")
        if binary:
            if split:
                raise ValueError("binary=True is incompatible with "
                                 "split=True (long-form uses JSON)")
            payload = utterance_to_binary(phonemes, style, puncts)
            hdrs = {"Content-Type": "application/octet-stream"}
        else:
            payload = json.dumps(_utterance_body(phonemes, style,
                                                 puncts)).encode()
            hdrs = _JSON_HDRS
        for attempt in range(self.retries_503 + 1):
            c = self._connect()
            c.request("POST", path, payload, hdrs)
            r = c.getresponse()
            if r.status == 503 and attempt < self.retries_503:
                r.read()
                c.close()
                time.sleep(_retry_after_s(r))
                continue
            break
        try:
            if r.status >= 300:
                raise TTSServerError(r.status, _error_text(r.read()))
            header = b""
            while len(header) < 44:
                piece = r.read(44 - len(header))
                if not piece:
                    raise TTSServerError(499, "stream ended inside header")
                header += piece
            if header[:4] != b"RIFF":
                raise ValueError("stream is not a RIFF/WAVE body")
            carry = b""
            while True:
                piece = r.read(read_size)
                if not piece:
                    break
                buf = carry + piece
                cut = len(buf) - (len(buf) & 1)
                carry = buf[cut:]
                if cut:
                    yield np.frombuffer(buf[:cut], dtype="<i2")
            if carry:
                raise TTSServerError(499, "stream ended mid-sample")
        finally:
            c.close()


def _error_text(data: bytes) -> str:
    try:
        return json.loads(data)["error"]
    except (ValueError, KeyError, TypeError):
        return data.decode(errors="replace")[:200] or "(empty body)"


def utterance(phonemes: Sequence[int], style: Sequence[float],
              puncts: Optional[Sequence[int]] = None) -> dict:
    """Public alias for building one /batch utterance dict."""
    return _utterance_body(phonemes, style, puncts)


def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    from ..io.wav import write_wav

    ap = argparse.ArgumentParser(
        description="Send one utterance JSON to a zerovox daemon")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--json", required=True,
                    help="utterance JSON file (phonemes/style[/puncts])")
    ap.add_argument("--out", required=True, help="output WAV path")
    ap.add_argument("--stream", action="store_true",
                    help="use /stream and report time-to-first-chunk")
    ap.add_argument("--split", action="store_true",
                    help="long-form mode: server splits at punctuation")
    ap.add_argument("--no-trim", action="store_true")
    args = ap.parse_args(argv)

    with open(args.json) as f:
        utt = json.load(f)
    cli = TTSClient(args.host, args.port)
    sr = cli.health()["sampling_rate"]
    if args.stream:
        t0 = time.perf_counter()
        chunks, first = [], None
        for ch in cli.stream(utt["phonemes"], utt["style"],
                             utt.get("puncts"), split=args.split):
            if first is None:
                first = time.perf_counter() - t0
            chunks.append(ch)
        wav = np.concatenate(chunks) if chunks else np.zeros(0, np.int16)
        print(f"first chunk after {first * 1e3:.1f} ms; "
              f"{len(wav)} samples total")
    else:
        wav, sr = cli.synthesize(utt["phonemes"], utt["style"],
                                 utt.get("puncts"), trim=not args.no_trim,
                                 split=args.split)
    write_wav(args.out, wav, sr)
    print(f"wrote {args.out}: {len(wav)} samples @ {sr} Hz "
          f"({len(wav) / sr:.2f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
