"""Split one warm daemon's /synthesize latency into measured layers (the
port of scripts/measure_daemon_attrib.py).

    python -m zerovox_tpu_torch.tools.measure_daemon_attrib [--reps 15] [--tiny] [--device cpu]

All from the same process and daemon (bfloat16, init_params(seed=0) with
the duration predictor's bias raised by 1.5):

  engine_ms      engine.synthesize() called directly in the process: the
                 front and vocoder launches and the int16 wav's host fetch
  handler_ms     the server's own per-request handler p50 (GET /metrics):
                 the engine, the request's parse and the WAV framing
  client_ms      the p50 at the client's socket: HTTP and loopback TCP on top
  parse_ms       client p50 with a JSON body minus with a binary body: the
                 JSON decode's share

so handler - engine is the parse and the framing, client - handler the
HTTP server loop.  Prints ONE JSON line with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import time

import numpy as np

from . import measure


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=15)
    measure.add_device_flags(ap)
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be >= 1")
    dev = measure.start(args.device)

    from ..config import TINY_CONFIG, ZeroVoxConfig
    from ..params import init_params
    from ..runtime.server import TTSServer
    from ..runtime.utterance import utterance_to_binary

    cfg = TINY_CONFIG if args.tiny else ZeroVoxConfig()
    params = measure.shift_duration(init_params(cfg, seed=0, device=dev))

    rng = np.random.default_rng(0)
    ph = rng.integers(1, cfg.num_phonemes, size=cfg.max_n_phonemes)
    pu = rng.integers(0, cfg.num_puncts, size=cfg.max_n_phonemes)
    sty = rng.normal(scale=0.1, size=cfg.d_model).astype(np.float32)
    jbody = json.dumps({"phonemes": ph.tolist(), "puncts": pu.tolist(),
                        "style": sty.tolist()}).encode()
    bbody = utterance_to_binary(ph, sty, pu)

    t0 = time.perf_counter()
    server = TTSServer(params, cfg, port=0, precision="bfloat16", warmup=True, device=dev)
    server.start()
    print(f"warmup+start {time.perf_counter()-t0:.1f}s on {measure.card_line(dev)}",
          file=sys.stderr, flush=True)
    host, port = server.address

    def post(path, body, ctype):
        c = http.client.HTTPConnection(host, port, timeout=300)
        t0 = time.perf_counter()
        c.request("POST", path, body, {"Content-Type": ctype})
        r = c.getresponse()
        r.read()
        if r.status != 200:
            raise RuntimeError(f"{path} answered {r.status}")
        return time.perf_counter() - t0

    def metrics():
        c = http.client.HTTPConnection(host, port, timeout=60)
        c.request("GET", "/metrics")
        return json.loads(c.getresponse().read())

    try:
        post("/synthesize", jbody, "application/json")
        post("/synthesize", bbody, "application/octet-stream")

        # the engine directly, in this process
        src = np.zeros((1, cfg.max_n_phonemes), np.int32)
        src[0] = ph
        pun = np.zeros_like(src)
        pun[0] = pu
        n = np.asarray([cfg.max_n_phonemes], np.int32)
        engine = server.engine
        engine.synthesize(src, pun, sty.reshape(1, -1), n, pcm16=True)
        eng = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            engine.synthesize(src, pun, sty.reshape(1, -1), n, pcm16=True)
            eng.append(time.perf_counter() - t0)

        # the socket's p50s, by body format
        base_count = metrics()["endpoints"].get("/synthesize", {}).get("count", 0)
        cj = [post("/synthesize", jbody, "application/json") for _ in range(args.reps)]
        mj = metrics()["endpoints"]["/synthesize"]
        cb = [post("/synthesize", bbody, "application/octet-stream") for _ in range(args.reps)]
        mb = metrics()["endpoints"]["/synthesize"]
    finally:
        server.shutdown()
    measure.report_launches("measure_daemon_attrib", "bfloat16")
    engine_ms = float(np.median(eng) * 1e3)
    client_json_ms = float(np.median(cj) * 1e3)
    client_bin_ms = float(np.median(cb) * 1e3)
    # the handler p50s come from the server's own ring of the last requests:
    # the second snapshot holds both windows
    out = {
        "engine_ms": round(engine_ms, 1),
        "client_json_p50_ms": round(client_json_ms, 1),
        "client_binary_p50_ms": round(client_bin_ms, 1),
        "json_minus_binary_ms": round(client_json_ms - client_bin_ms, 1),
        "handler_p50_after_json_ms": mj.get("p50_ms"),
        "handler_p50_after_all_ms": mb.get("p50_ms"),
        "requests": mb.get("count", 0) - base_count,
        "gap_client_minus_engine_ms": round(client_json_ms - engine_ms, 1),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
