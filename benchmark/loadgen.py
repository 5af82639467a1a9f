"""The load generator: closed-loop HTTP clients in a process without torch.

    python benchmark/loadgen.py --mix MIX.json --model '{"num_phonemes": ...}'
        --seed N --seconds S --port P --out DIR [--sample K]

The clients run here, in a child process of the harness that imports numpy
and the standard library only, so that they never hold the daemon's
interpreter lock.  Each client is a thread with one kept-alive connection;
it sends its next request as soon as the previous answer has fully arrived
(a closed loop) and never retries: a request that fails (a socket error, a
status other than 200, a short answer) is recorded as failed.

Protocol with the harness: after every client has sent the mix's warm-up
requests (not recorded), the child prints "READY" on standard output and
waits for a line "GO" on standard input.  From then on the clients send
for `--seconds`; requests already sent when that time is up are waited
for.  The child then writes DIR/log.json (one row per request of the
window: times on the host's monotonic clock, status, samples per
utterance, the X-Batch-Size header) and DIR/sample.npz (the answers of the
checked sample: the `--sample` requests with the smallest seeded keys,
and the longest answer of the window), and exits.

Derived from the port's tools/bench_daemon.py client logic, rewritten for
a closed loop of N clients in a process of its own.
"""

from __future__ import annotations

import argparse
import heapq
import http.client
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):                       # run as a script
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark import traffic  # noqa: E402


class Failed(Exception):
    pass


def _read_answer(mix: dict, resp) -> tuple:
    """(first audio byte time, [PCM16 bytes per utterance]) of a 200 answer."""
    if mix["endpoint"] == "/stream":
        head = resp.read(traffic.WAV_HEADER)
        if len(head) != traffic.WAV_HEADER:
            raise Failed("stream ended inside its header")
        first = resp.read(2)
        t_first = time.monotonic()
        rest = resp.read()
        if len(first) != 2:
            raise Failed("stream carried no audio")
        return t_first, [first + rest]
    body = resp.read()
    t_first = time.monotonic()
    if mix["endpoint"] == "/batch":
        return t_first, traffic.batch_pcms(body)
    return t_first, [traffic.pcm_of_wav(body)]


class Clients:
    def __init__(self, mix, model, seed, seconds, port, sample):
        self.mix, self.model, self.seed = mix, model, seed
        self.seconds, self.port, self.n_sample = seconds, port, sample
        self.pool = traffic.make_pool(mix, model, seed)
        self.go = threading.Event()
        self.t_go = 0.0
        self.ready = threading.Barrier(mix["clients"] + 1)
        self.lock = threading.Lock()
        self.records = []
        self.heap = []            # (-key, id, pcms): the sample's requests
        self.longest = None       # (samples, id, pcms)

    def _send(self, conn, body):
        conn.request("POST", self.mix["endpoint"], body,
                     {"Content-Type": traffic.content_type(self.mix)})
        resp = conn.getresponse()
        if resp.status != 200:
            resp.read()
            raise Failed(f"status {resp.status}")
        t_first, pcms = _read_answer(self.mix, resp)
        return t_first, pcms, resp.getheader("X-Batch-Size")

    def _connect(self):
        return http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)

    def client(self, c: int):
        mix = self.mix
        cache: dict = {}
        conn = self._connect()
        order = traffic.client_requests(mix, self.seed, c)
        try:
            for _ in range(mix["warmup_requests"]):
                self._send(conn, traffic.request_body(mix, self.pool, next(order), cache))
        except Exception as e:                           # noqa: BLE001
            print(f"loadgen: client {c} warm-up failed: {e!r}", file=sys.stderr, flush=True)
            conn.close()
            conn = self._connect()
        self.ready.wait()
        self.go.wait()
        end = self.t_go + self.seconds
        k = 0
        while time.monotonic() < end:
            idxs = next(order)
            body = traffic.request_body(mix, self.pool, idxs, cache)
            t_send = time.monotonic()
            row = {"client": c, "k": k, "idxs": idxs, "t_send": t_send}
            try:
                t_first, pcms, bsize = self._send(conn, body)
                row.update(t_first=t_first, t_done=time.monotonic(), status=200,
                           samples=[len(p) // 2 for p in pcms], batch_size=bsize)
                self._keep(row, pcms)
            except Exception as e:                       # noqa: BLE001
                row.update(t_done=time.monotonic(), status=-1, error=repr(e)[:200])
                print(f"loadgen: client {c} request {k} failed: {e!r}", file=sys.stderr,
                      flush=True)
                conn.close()
                conn = self._connect()
            with self.lock:
                self.records.append(row)
            k += 1
        conn.close()

    def _keep(self, row, pcms):
        key = traffic.sample_key(self.seed, row["client"], row["k"])
        rid = (row["client"], row["k"])
        total = sum(row["samples"])
        with self.lock:
            item = (-key, rid, pcms)
            if len(self.heap) < self.n_sample:
                heapq.heappush(self.heap, item)
            elif -key > self.heap[0][0]:
                heapq.heapreplace(self.heap, item)
            if self.longest is None or total > self.longest[0]:
                self.longest = (total, rid, pcms)

    def run(self, out: Path):
        threads = [threading.Thread(target=self.client, args=(c,), daemon=True)
                   for c in range(self.mix["clients"])]
        for t in threads:
            t.start()
        self.ready.wait()
        print("READY", flush=True)
        line = sys.stdin.readline().strip()
        if line != "GO":
            print(f"loadgen: expected GO, got {line!r}", file=sys.stderr, flush=True)
            return 2
        self.t_go = time.monotonic()
        self.go.set()
        for t in threads:
            t.join(self.seconds + 400)
        alive = sum(t.is_alive() for t in threads)
        with self.lock:
            kept = {rid: pcms for _, rid, pcms in self.heap}
            if self.longest is not None:
                kept[self.longest[1]] = self.longest[2]
            arrays = {}
            sample = []
            for n, (rid, pcms) in enumerate(sorted(kept.items())):
                sample.append({"client": rid[0], "k": rid[1], "n_utts": len(pcms)})
                for j, p in enumerate(pcms):
                    arrays[f"a{n}_{j}"] = np.frombuffer(p, "<i2")
            log = {"t_go": self.t_go, "seconds": self.seconds, "records": self.records,
                   "sample": sample, "hung_clients": alive}
        np.savez(out / "sample.npz", **arrays)
        (out / "log.json").write_text(json.dumps(log))
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mix", required=True)
    ap.add_argument("--model", required=True, help="JSON: num_phonemes, num_puncts, d_model")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--sample", type=int, default=16)
    args = ap.parse_args(argv)
    mix = json.loads(Path(args.mix).read_text())
    out = Path(args.out)
    os.makedirs(out, exist_ok=True)
    return Clients(mix, json.loads(args.model), args.seed, args.seconds, args.port,
                   args.sample).run(out)


if __name__ == "__main__":
    sys.exit(main())
