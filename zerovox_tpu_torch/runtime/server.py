"""HTTP serving daemon: a warm engine answering synthesis requests.

The port of zerovox_tpu/runtime/server.py, with the same wire format (either
package's client talks to either daemon).  Deliberately stdlib-only
(http.server): a threading HTTP server, one handler thread per connection
in flight, sharing one `TTSEngine` and one `StreamingSynthesizer` that read
the same weights (the engine's LoadedModel, held once).  With mesh= it
serves over several devices: a pure-DP engine with /stream sessions rotated
over the devices, or, with a model axis > 1, the tensor-parallel engine
(runtime/tp_engine.py).  Stream state is local to each generator, so
concurrent /stream requests interleave freely.

A handler thread parses, waits and writes; the launches of its request are
issued on the issuing thread of each device it runs on
(device.on_issuing_thread, through the engine and the synthesizer), in the
order the requests reach it, on the device's default CUDA stream.  So
concurrent requests run on one card one after the other, and a /stream
chunk waits behind whatever was queued on its device before it.  The
reasons for one issuing thread per device (cuDNN's per-thread plans, the
interpreter lock) are in the docstring of device.on_issuing_thread.

Endpoints (all JSON bodies use the CLI's utterance schema:
{"phonemes": [...], "style": [...], "puncts": optional}):

  GET  /healthz      -> {"status": "ok", "sampling_rate": ..., ...}
  GET  /metrics      -> per-endpoint request counts, error counts, and
                        p50/p95/max latency over the last 512 requests;
                        the device's name and memory; the batcher's counts
                        (?format=prometheus: the same as exposition text)
  POST /synthesize   -> complete WAV (query: ?trim=0 keeps the padded
                        buffer); with batch_window_ms > 0, concurrent
                        requests coalesce into packed dispatches
                        (runtime/batcher.py) and the answer's X-Batch-Size
                        header says at which batch size it ran; ?split=1 accepts utterances
                        of ANY length, split at punctuation into one packed
                        batch (runtime/longform.py)
  POST /batch        -> {"utterances": [utt, ...]} -> JSON array of
                        base64 WAVs via the bucket-packed engine path
                        (one vocoder dispatch per mel bucket group)
  POST /stream       -> chunked WAV: the 44-byte header (streaming-size
                        convention) followed by PCM16 the moment each
                        vocoder chunk lands; the time to the first byte is
                        the stream's time to first audio, not the
                        utterance's length (?split=1 as above)
  POST /reload       -> {"model": path}: hot-swap weights from a new
                        same-geometry GGUF without a restart (opt-in:
                        allow_reload / --allow-reload; 403 otherwise, 409
                        on a geometry change)

/synthesize and /stream also accept Content-Type:
application/octet-stream with the raw-binary utterance body
(runtime/utterance.py: utterance_to_binary).
"""

from __future__ import annotations

import base64
import json
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import resolve_device
from ..io.wav import _wav_header
from .utterance import (parse_utterance_arrays, utterance_from_binary,
                        utterance_from_dict)


class RequestTooLarge(ValueError):
    """Request body exceeds the server's cap (HTTP 413)."""


class Metrics:
    """Per-endpoint request counters + latency quantiles (GET /metrics).

    Latencies keep a bounded ring (last `window` requests per endpoint) and
    the endpoint set itself is bounded by the caller (do_POST buckets
    unknown paths under "other"), so memory stays O(1) under load,
    attacker-chosen URLs included.
    """

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._window = window
        self._t0 = time.time()
        self._ep: dict = {}

    def record(self, endpoint: str, status: int, seconds: float):
        with self._lock:
            ep = self._ep.setdefault(endpoint, {
                "count": 0, "errors": 0, "lat": [], "i": 0})
            ep["count"] += 1
            if status >= 400:
                ep["errors"] += 1
            if len(ep["lat"]) < self._window:
                ep["lat"].append(seconds)
            else:
                ep["lat"][ep["i"] % self._window] = seconds
            ep["i"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = {"uptime_s": round(time.time() - self._t0, 3),
                   "endpoints": {}}
            for name, ep in self._ep.items():
                lat = sorted(ep["lat"])
                q = (lambda p: round(
                    1e3 * lat[min(len(lat) - 1, int(p * len(lat)))], 3)
                    ) if lat else (lambda p: None)
                out["endpoints"][name] = {
                    "count": ep["count"], "errors": ep["errors"],
                    "p50_ms": q(0.50), "p95_ms": q(0.95), "max_ms": q(1.0),
                }
            return out


def prometheus_text(snap: dict) -> str:
    """Render a /metrics snapshot in the Prometheus exposition format.

    The JSON snapshot stays the primary schema; this is the same data
    re-keyed for scrape-based monitoring (GET /metrics?format=prometheus).
    Latency quantiles are converted ms -> seconds per Prometheus
    convention; they are windowed quantiles (last 512 requests), exposed
    as gauges rather than a native summary.
    """
    lines = [
        "# HELP zerovox_uptime_seconds Daemon uptime.",
        "# TYPE zerovox_uptime_seconds gauge",
        f"zerovox_uptime_seconds {snap['uptime_s']}",
        "# TYPE zerovox_requests_total counter",
        "# TYPE zerovox_request_errors_total counter",
        "# TYPE zerovox_request_latency_seconds gauge",
    ]
    for name, ep in sorted(snap.get("endpoints", {}).items()):
        lab = f'{{endpoint="{name}"}}'
        lines.append(f"zerovox_requests_total{lab} {ep['count']}")
        lines.append(f"zerovox_request_errors_total{lab} {ep['errors']}")
        for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                       ("1.0", "max_ms")):
            if ep.get(key) is not None:
                lines.append(
                    f'zerovox_request_latency_seconds{{endpoint="{name}",'
                    f'quantile="{q}"}} {ep[key] / 1e3:.6f}')
    for d in snap.get("device", {}).get("devices", []):
        lab = f'{{device="{d["id"]}",platform="{d["platform"]}"}}'
        # info-style inventory line: always present, even where the device
        # reports no memory (the CPU), so a dashboard can count devices and
        # alert on the gauge disappearing
        lines.append(f"zerovox_device_up{lab} 1")
        for key in ("bytes_in_use", "bytes_limit"):
            if key in d:
                lines.append(f"zerovox_device_{key}{lab} {d[key]}")
    for key, val in sorted(snap.get("batcher", {}).items()):
        if isinstance(val, (int, float)):
            lines.append(f"zerovox_batcher_{key} {val}")
    return "\n".join(lines) + "\n"


def _device_stats(device: torch.device) -> dict:
    """The server's own device for /metrics: its name and, on a card, the
    memory PyTorch has allocated there and the card's total (an operator
    watching a resident daemon needs to see memory pressure before an
    out-of-memory error, not after).  The CPU reports no memory."""
    version = f"torch {torch.__version__}"
    if device.type != "cuda":
        return {"devices": [{"id": 0, "kind": "cpu", "platform": "cpu"}],
                "platform_version": version}
    try:
        index = device.index if device.index is not None else torch.cuda.current_device()
        row = {"id": index, "kind": torch.cuda.get_device_name(index),
               "platform": "gpu",
               "bytes_in_use": int(torch.cuda.memory_allocated(index)),
               "bytes_limit": int(torch.cuda.mem_get_info(index)[1])}
    except RuntimeError as e:               # the card went away mid-call
        return {"error": str(e)[:200]}
    return {"devices": [row],
            "platform_version": f"{version}, CUDA {torch.version.cuda}"}


class _HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer (a thread per connection) with a listen backlog
    that holds a burst of connections (the default of 5 drops the SYNs
    beyond it, which the clients send again a second later) and without a
    traceback for a client that resets its connection."""

    request_queue_size = 128

    def handle_error(self, request, client_address):
        # a client that resets a kept-alive connection between two requests
        # is no fault of the server's
        if not isinstance(sys.exc_info()[1], OSError):
            super().handle_error(request, client_address)


class TTSServer:
    """Thread-per-connection HTTP server over a warm TTSEngine."""

    def __init__(self, params, cfg: ZeroVoxConfig,
                 host: str = "127.0.0.1", port: int = 8765,
                 precision: str = "float32",
                 mel_buckets: Sequence[int] = (256, 512, 1024),
                 chunk_frames: int = 64, overlap: int = 16,
                 warmup: bool = True,
                 max_body_bytes: int = 4 << 20, max_batch: int = 64,
                 batch_window_ms: float = 0.0,
                 allow_reload: bool = False, max_concurrent: int = 64,
                 device="cuda", mesh=None):
        """mesh: multi-device serving (`device` is then not read).  Model
        axis 1: a pure-DP TTSEngine over the data devices (pairs with the
        batcher, which fills the wider ladder), and /stream sessions rotated
        over mesh.devices.flat.  Model axis > 1: a TPServingEngine (the
        front channel-sharded, the vocoder time-sharded), and /stream on the
        mesh's first device (stream windows are too short to gain from
        channel sharding)."""
        from ..models.streaming import StreamingSynthesizer
        from .engine import TTSEngine

        # input caps: a single oversized request must not exhaust host
        # memory or mint unbounded device work on a production server
        self.max_body_bytes = int(max_body_bytes)
        self.max_batch = int(max_batch)
        # Bind the listening socket BEFORE any device work: a port conflict
        # must surface now, not after the warm-up (which builds the MRF
        # kernel with nvcc on a card), and a bound-but-not-yet-serving
        # socket lets an orchestrator's TCP liveness probe tell "warming"
        # from "dead".  The real handler class is attached at the end of
        # __init__; nothing is accepted until serve_forever().
        self._httpd = _HTTPServer((host, port), None)
        self._serving = threading.Event()
        # /reload loads a checkpoint PATH from the request body: opt-in
        # only (CLI --allow-reload), for deployments where the daemon is
        # behind a trusted admin plane
        self.allow_reload = bool(allow_reload)
        self._reload_lock = threading.Lock()
        # admission control: at most max_concurrent synthesis/stream
        # requests in flight; excess answers 503 + Retry-After (load is
        # shed fast instead of piling threads on a saturated device)
        self._admission = threading.Semaphore(max(1, int(max_concurrent)))
        self.metrics = Metrics()
        self.batcher = None
        try:
            n_model = 1
            if mesh is not None:
                from ..parallel.mesh import MODEL_AXIS
                n_model = mesh.shape.get(MODEL_AXIS, 1)
            if n_model > 1:
                from .tp_engine import TPServingEngine
                self.engine = TPServingEngine(params, cfg, mesh, precision=precision)
            else:
                self.engine = TTSEngine(params, cfg, mel_buckets=mel_buckets,
                                        precision=precision, mesh=mesh,
                                        device=resolve_device(device) if mesh is None else None)
            self.device = self.engine.device
            # the synthesizer reads the engine's own LoadedModel (weights
            # cast for the precision, packed for the MRF kernel): held once
            self.stream = StreamingSynthesizer(
                self.engine.model, self.engine.cfg,
                chunk_frames=chunk_frames, overlap=overlap,
                pcm16=True,  # chunks arrive device-quantised (half the bytes)
                device=self.device,
                devices=list(mesh.devices.flat) if mesh is not None and n_model == 1 else None)
            if warmup:
                # /synthesize serves the device-quantised int16 variants.
                # Warm at the ladder TOP so that every front and vocoder
                # shape any /batch mix can hit has run once (the kernel is
                # built, cuDNN has made its plans on the issuing thread)
                # before the first request.
                self.engine.warmup(batch=self.engine.batch_ladder[-1],
                                   pcm16=True)
                self.stream.warmup()

            # dynamic batching (off by default): concurrent /synthesize
            # requests arriving within the window share one packed
            # dispatch (runtime/batcher.py)
            if batch_window_ms > 0:
                from .batcher import DynamicBatcher
                self.batcher = DynamicBatcher(self.engine,
                                              window_ms=batch_window_ms)
        except BaseException:
            # construction/warmup failed: release the early-bound port
            # deterministically (no dangling listener until GC)
            self._httpd.server_close()
            raise

        server = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer framing only exists in HTTP/1.1: the 1.0
            # default would make version-honoring clients read the raw
            # chunk-size lines into the audio.  Every response therefore
            # carries Content-Length or Transfer-Encoding (1.1 keep-alive).
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                # a stalled client must time out rather than pin its
                # handler thread (and, worse, anything it holds) forever
                self.connection.settimeout(300)

            # quiet per-request stderr lines; errors still surface as codes
            def log_message(self, *a):
                pass

            def _json(self, code: int, obj: dict):
                self._status = code
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_body(self) -> bytes:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    raise ValueError("empty request body")
                if length > server.max_body_bytes:
                    raise RequestTooLarge(
                        f"request body {length} bytes exceeds the "
                        f"{server.max_body_bytes}-byte cap")
                return self.rfile.read(length)

            def _read_json(self):
                return json.loads(self._read_body())

            def _is_binary(self) -> bool:
                ctype = self.headers.get("Content-Type", "")
                return ctype.split(";")[0].strip() == \
                    "application/octet-stream"

            def _read_utterance(self):
                # Content-Type: application/octet-stream selects the
                # raw-binary utterance body; same validation, same 400s
                if self._is_binary():
                    return utterance_from_binary(self._read_body(),
                                                 server.engine.cfg)
                return utterance_from_dict(self._read_json(),
                                           server.engine.cfg)

            def do_GET(self):
                url = urlparse(self.path)
                path = url.path
                if path == "/metrics":
                    snap = server.metrics.snapshot()
                    if server.batcher is not None:
                        snap["batcher"] = server.batcher.snapshot()
                    snap["device"] = _device_stats(server.device)
                    fmt = parse_qs(url.query).get("format", [""])[0]
                    if fmt == "prometheus":
                        body = prometheus_text(snap).encode()
                        self._status = 200
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "text/plain; version=0.0.4; charset=utf-8")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    return self._json(200, snap)
                if path != "/healthz":
                    return self._json(404, {"error": "unknown endpoint"})
                cfg = server.engine.cfg
                self._json(200, {
                    "status": "ok",
                    "sampling_rate": cfg.sampling_rate,
                    "max_seq_len": cfg.max_seq_len,
                    "precision": cfg.compute_dtype,
                    "mel_buckets": list(server.engine.mel_buckets),
                    "platform_version":
                        _device_stats(server.device).get("platform_version", ""),
                })

            # the metrics key set must be bounded: recording raw request
            # paths would grow one ring buffer per attacker-chosen URL
            KNOWN_ENDPOINTS = frozenset(
                ("/synthesize", "/batch", "/stream", "/reload"))

            def do_POST(self):
                url = urlparse(self.path)
                endpoint = (url.path if url.path in self.KNOWN_ENDPOINTS
                            else "other")
                t0 = time.perf_counter()
                try:
                    return self._route(url)
                finally:
                    server.metrics.record(endpoint, self._status,
                                          time.perf_counter() - t0)

            def _route(self, url):
                self._body_started = False
                self._status = 200
                try:
                    if url.path in ("/synthesize", "/batch", "/stream"):
                        # admission control: ThreadingHTTPServer spawns a
                        # thread per connection, so without a cap an
                        # overload storm piles unbounded threads (and
                        # batcher queue) onto a device that cannot keep
                        # up.  Shed load FAST with 503 + Retry-After
                        # instead: the client's retry lands when slots
                        # free up.
                        if not server._admission.acquire(blocking=False):
                            self.send_response(503)
                            self.send_header("Retry-After", "1")
                            self.send_header("Content-Length", "0")
                            self.end_headers()
                            self._status = 503
                            return
                        try:
                            if url.path == "/synthesize":
                                return self._synthesize(url)
                            if url.path == "/batch":
                                return self._batch(url)
                            return self._stream(url)
                        finally:
                            server._admission.release()
                    if url.path == "/reload":
                        return self._reload(url)
                    return self._json(404, {"error": "unknown endpoint"})
                except (ValueError, json.JSONDecodeError) as e:
                    if self._body_started:
                        # headers (and possibly chunks) are on the wire: a
                        # JSON error response here would be parsed as
                        # chunk framing; drop the connection instead so
                        # the client sees a truncated (invalid) stream
                        self._status = 500
                        self.close_connection = True
                        return
                    code = 413 if isinstance(e, RequestTooLarge) else 400
                    if code == 413:
                        # the oversized body was never read; drop the
                        # connection after responding rather than parsing
                        # the leftover bytes as the next request
                        self.close_connection = True
                    try:
                        return self._json(code, {"error": str(e)})
                    except OSError:
                        # client already gone before reading its error
                        self.close_connection = True
                        return
                except OSError:
                    # client went away mid-response (BrokenPipe on a /stream
                    # chunk write, reset, timeout): close quietly instead of
                    # killing the handler thread with a traceback
                    self._status = 499          # nginx's client-closed code
                    self.close_connection = True
                    return
                except Exception as e:          # noqa: BLE001
                    # anything unanticipated must still produce an HTTP
                    # error and an accurate metrics row, not a dead handler
                    # thread recorded as a 200.  Detail goes to the server
                    # log only: exception text can carry paths, shapes and
                    # internals a network client has no business seeing
                    print(f"server: 500 on {url.path}: "
                          f"{type(e).__name__}: {e}", file=sys.stderr)
                    traceback.print_exc()
                    self._status = 500
                    if self._body_started:
                        self.close_connection = True
                        return
                    try:
                        return self._json(500, {"error": "internal error"})
                    except OSError:
                        self.close_connection = True
                        return

            def _synthesize(self, url):
                q = parse_qs(url.query)
                batch_size = None
                if q.get("split", ["0"])[0] != "0":
                    # long-form mode: utterances of ANY length split at
                    # punctuation boundaries into one packed dispatch
                    # (runtime/longform.py); split implies trim: the
                    # windows' padded tails cannot meaningfully concat
                    from .longform import synthesize_long
                    ph, pu, style = parse_utterance_arrays(
                        self._read_json(), server.engine.cfg)
                    if len(ph) == 0:
                        raise ValueError("empty phoneme sequence")
                    # each split window is one utterance of device work:
                    # bound it by the same cap as /batch, or one request
                    # could mint minutes of dispatches inside its one
                    # admission slot
                    wav, _ = synthesize_long(server.engine, ph, pu, style,
                                             pcm16=True,
                                             max_windows=server.max_batch)
                else:
                    src, pun, style, n = self._read_utterance()
                    trim = q.get("trim", ["1"])[0] != "0"
                    if server.batcher is not None:
                        wav, _, batch_size = server.batcher.synthesize_sized(
                            src, pun, style, n, trim=trim, pcm16=True)
                    else:
                        wavs, _ = server.engine.synthesize(
                            src, pun, style, n, trim=trim, pcm16=True)
                        wav = wavs[0]
                pcm = wav.tobytes()
                sr = server.engine.cfg.sampling_rate
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(44 + len(pcm)))
                if batch_size is not None:
                    # the batch size the batcher computed this answer at
                    self.send_header("X-Batch-Size", str(batch_size))
                self.end_headers()
                self.wfile.write(_wav_header(sr, len(pcm)))
                self.wfile.write(pcm)

            def _reload(self, url):
                """Hot-swap weights from a new GGUF of the same geometry:
                one weight transfer and one packing instead of a daemon
                restart.  Changes of geometry go through a restart."""
                if not server.allow_reload:
                    return self._json(
                        403, {"error": "reload disabled; start the "
                                       "daemon with --allow-reload"})
                body = self._read_json()
                path = body.get("model")
                if not isinstance(path, str) or not path:
                    raise ValueError("need {'model': '/path/to.gguf'}")
                from ..params import load_params
                try:
                    new_cfg, new_params = load_params(path, device=server.device)
                except (OSError, EOFError, KeyError) as e:
                    return self._json(400, {
                        "error": f"cannot load {path!r}: {e}"})
                cfg = server.engine.cfg
                for f in ("max_seq_len", "max_n_phonemes", "d_model",
                          "num_mels", "sampling_rate", "hop_size"):
                    if getattr(new_cfg, f) != getattr(cfg, f):
                        return self._json(409, {
                            "error": f"geometry changed ({f}: "
                                     f"{getattr(new_cfg, f)} vs "
                                     f"{getattr(cfg, f)}); restart the "
                                     "daemon for geometry changes"})
                with server._reload_lock:
                    try:
                        server.engine.reload_params(new_params)
                    except ValueError as e:
                        return self._json(409, {"error": str(e)})
                    # one reference for both: a stream in flight finishes
                    # on the pair it started with
                    server.stream.set_params(server.engine.model)
                self._json(200, {"status": "reloaded", "model": path})

            def _batch(self, url):
                utts = self._read_json().get("utterances")
                if not isinstance(utts, list) or not utts:
                    raise ValueError("need a non-empty 'utterances' list")
                if len(utts) > server.max_batch:
                    raise ValueError(
                        f"{len(utts)} utterances exceeds the per-request "
                        f"cap of {server.max_batch}")
                cfg = server.engine.cfg
                parsed = [utterance_from_dict(u, cfg) for u in utts]
                src = np.concatenate([p[0] for p in parsed])
                pun = np.concatenate([p[1] for p in parsed])
                sty = np.concatenate([p[2] for p in parsed])
                n = np.concatenate([p[3] for p in parsed])
                trim = parse_qs(url.query).get("trim", ["1"])[0] != "0"
                wavs, mel_len = server.engine.synthesize_packed(
                    src, pun, sty, n, trim=trim, pcm16=True)
                sr = cfg.sampling_rate
                out = [base64.b64encode(
                           _wav_header(sr, 2 * len(w))
                           + w.tobytes()).decode()
                       for w in wavs]
                self._json(200, {"wavs": out,
                                 "mel_len": [int(m) for m in mel_len]})

            def _stream(self, url):
                q = parse_qs(url.query)
                if q.get("split", ["0"])[0] != "0":
                    # long-form streaming: each punctuation-split window
                    # streams in turn into the same chunked response
                    from .longform import split_utterance
                    cfg = server.engine.cfg
                    ph, pu, style = parse_utterance_arrays(
                        self._read_json(), cfg)
                    if len(ph) == 0:
                        raise ValueError("empty phoneme sequence")
                    srcs, puns, lens = split_utterance(
                        ph, pu, cfg.max_n_phonemes)
                    if len(lens) > server.max_batch:   # same cap as /batch
                        raise ValueError(
                            f"utterance splits into {len(lens)} windows, "
                            f"exceeding the cap of {server.max_batch}; "
                            "send it in several requests")
                    windows = [(srcs[i:i + 1], puns[i:i + 1], style,
                                lens[i:i + 1]) for i in range(len(lens))]
                else:
                    windows = [self._read_utterance()]
                sr = server.engine.cfg.sampling_rate
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._body_started = True

                def chunk(b: bytes):
                    self.wfile.write(f"{len(b):X}\r\n".encode())
                    self.wfile.write(b)
                    self.wfile.write(b"\r\n")
                    self.wfile.flush()

                # streaming-WAV convention: unknown-length sizes; players
                # read until the stream ends
                chunk(_wav_header(sr, 0xFFFFFFFF - 44))
                # no server-side lock: stream state is generator-local
                for src, pun, style, n in windows:
                    for piece in server.stream.stream(src, pun, style, n):
                        chunk(piece.tobytes())       # int16: the synthesizer is pcm16
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

        # socket was bound (and the port claimed) at the top of __init__;
        # attaching the handler class arms it for serve_forever()
        self._httpd.RequestHandlerClass = Handler
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def serve_forever(self):
        self._serving.set()
        self._httpd.serve_forever()

    def stop_serving(self):
        """Unblock serve_forever() from another thread (a signal handler's
        helper thread); the caller of serve_forever() then runs shutdown().
        BaseServer.shutdown() deadlocks on the thread that serves."""
        self._httpd.shutdown()

    def start(self):
        """Serve on a daemon thread (tests / embedding)."""
        # mark serving BEFORE the thread launches: a shutdown() racing the
        # thread's entry into serve_forever() must wait for it (BaseServer
        # handles the set-flag-first ordering), not skip the wait
        self._serving.set()
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()

    def shutdown(self):
        """Stop serving, close the listener, let the batcher drain."""
        # BaseServer.shutdown() waits on an event that only
        # serve_forever() ever sets: calling it on a server that never
        # started would block forever.  A constructed-but-never-served
        # TTSServer just closes its socket.
        if self._serving.is_set():
            self._httpd.shutdown()
        self._httpd.server_close()
        if self.batcher is not None:
            self.batcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
