"""The span recorder (zerovox_tpu_torch/utils/profiling.py) and the
benchmark's readers of it (benchmark/spans.py, benchmark/metrics/), on the CPU.

The recorder: nesting and causes, self time, the ring's bound, the per-name
totals, many threads at once, and nothing recorded while it is off.  The
request id crosses the issuing thread and the batcher, and one batched
/synthesize and one /batch of the daemon leave their whole span tree under
their request id.  A span and the profiler's events share one clock.  GET
/trace in both forms.  The six readers on synthetic entries, and None from
each where the program has no recorder.  Every wait has a timeout.
"""

import http.client
import json
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.device import on_issuing_thread
from zerovox_tpu_torch.runtime.batcher import DynamicBatcher
from zerovox_tpu_torch.runtime.engine import TTSEngine
from zerovox_tpu_torch.runtime.server import TTSServer
from zerovox_tpu_torch.utils import profiling

from benchmark import spans, spec
from benchmark.trace import Event, TraceData, reduce_events

CFG = TINY_CONFIG
TIMEOUT = 120
READERS = ("vocoder.fill", "vocoder.fill.card", "daemon.self_ms", "front.issue_ms",
           "device.idle_issuing", "daemon.warmup_s")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """TINY-size ops gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the process recorder's place, on."""
    r = profiling.SpanRecorder(size=1 << 12)
    monkeypatch.setattr(profiling, "RECORDER", r)
    r.on = True
    return r


@pytest.fixture(scope="module")
def params():
    return tparams.init_params(CFG, seed=0, device="cpu")


def _utt(seed, n=None):
    rng = np.random.default_rng(seed)
    P = CFG.max_n_phonemes
    return (rng.integers(1, CFG.num_phonemes, size=(1, P)).astype(np.int32),
            rng.integers(0, CFG.num_puncts, size=(1, P)).astype(np.int32),
            rng.normal(scale=0.1, size=(1, CFG.d_model)).astype(np.float32),
            np.asarray([P if n is None else n], np.int32))


def _by_name(entries):
    out = {}
    for e in entries:
        out.setdefault(e.name, []).append(e)
    return out


# --------------------------------------------------------------- the recorder

def test_nesting_causes_and_request_ids(rec):
    with profiling.span("outer", rid=7) as outer:
        assert profiling.request_id() == 7 and profiling.current_span() == outer.id
        with profiling.span("inner") as inner:
            profiling.count("frames", 3, 8)
    assert profiling.request_id() is None and profiling.current_span() is None
    e = _by_name(rec.entries())
    assert [x.name for x in rec.entries()] == ["frames", "inner", "outer"]   # in the order they end
    assert e["outer"][0].cause is None and e["inner"][0].cause == outer.id
    assert e["frames"][0].cause == inner.id and (e["frames"][0].a, e["frames"][0].b) == (3, 8)
    assert e["frames"][0].start == e["frames"][0].end
    assert {x.rid for x in rec.entries()} == {7}
    assert {x.thread for x in rec.entries()} == {threading.get_native_id()}
    o, i = e["outer"][0], e["inner"][0]
    assert o.start <= i.start <= i.end <= o.end and o.id == outer.id
    assert rec.thread_names()[threading.get_native_id()] == threading.current_thread().name


def test_self_time(rec):
    parent = profiling.Entry("p", 0, 100, 1, 1, None, None)
    kids = [profiling.Entry("c", s, e, 1, 2, None, 1) for s, e in ((10, 30), (20, 50), (90, 120))]
    assert spans.self_ns(parent, kids) == 100 - 40 - 10       # overlaps counted once, clipped
    assert spans.self_ns(parent, []) == 100
    with profiling.span("request"):
        time.sleep(0.01)
        with profiling.span("wait"):
            time.sleep(0.02)
    e = _by_name(rec.entries())
    req, wait = e["request"][0], e["wait"][0]
    assert wait.cause == req.id
    assert spans.self_ns(req, [wait]) == (req.end - req.start) - (wait.end - wait.start)
    assert 0.01e9 <= spans.self_ns(req, [wait]) < req.end - req.start


def test_ring_bound_and_totals():
    r = profiling.SpanRecorder(size=8)
    for i in range(20):
        r.add("s" if i % 2 else "c", 100 * i, 100 * i + (10 if i % 2 else 0), i, a=i, b=2 * i)
    ring = r.entries()
    assert len(ring) == 8 and [e.id for e in ring] == list(range(12, 20))
    assert r.added == 20
    t = r.totals()
    assert t["s"] == {"count": 10, "total_ns": 100, "a": sum(range(1, 20, 2)),
                      "b": 2 * sum(range(1, 20, 2))}
    assert t["c"]["count"] == 10 and t["c"]["total_ns"] == 0
    assert [e.id for e in r.entries(1500, 1700)] == [15, 16]          # overlapping [lo, hi)
    assert [e.id for e in r.entries(1600, 1610)] == [16]              # a counter stamped at lo
    with pytest.raises(ValueError):
        profiling.SpanRecorder(size=0)


def test_thread_safety(rec):
    n_threads, n_spans = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_spans):
                with profiling.span("t", rid=k):
                    profiling.count("n", 1)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    t = rec.totals()
    assert t["t"]["count"] == t["n"]["count"] == t["n"]["a"] == n_threads * n_spans
    ring = rec.entries()
    assert len(ring) == min(rec.size, 2 * n_threads * n_spans)
    assert len({e.id for e in ring}) == len(ring)
    spans_ = {e.id: e for e in ring if e.name == "t"}
    for c in (e for e in ring if e.name == "n" and e.cause in spans_):
        assert c.rid == spans_[c.cause].rid and c.thread == spans_[c.cause].thread


def test_off_records_nothing(rec):
    profiling.enable(False)
    assert not rec.on
    with profiling.span("a", rid=3) as s:
        assert s.id is None and profiling.request_id() is None
        profiling.count("c", 1, 2)
        profiling.record("r", 0, 10)
    fn = lambda: 5                                         # noqa: E731
    assert profiling.issued("issue.front", fn) is fn
    assert on_issuing_thread("cpu", fn, span="issue.front") == 5
    timed = profiling.Span("daemon.request")
    with timed:
        time.sleep(0.005)
    assert timed.seconds >= 0.005                          # the daemon's timer, on or off
    assert rec.entries() == [] and rec.totals() == {} and rec.added == 0
    profiling.enable()
    assert rec.on


def test_request_id_crosses_the_issuing_thread(rec):
    seen = {}

    def fn(x):
        seen.update(rid=profiling.request_id(), span=profiling.current_span(),
                    thread=threading.get_native_id())
        return x + 1

    with profiling.span("daemon.request", rid=11) as req:
        assert on_issuing_thread("cpu", fn, 1, span="issue.front") == 2
    e = _by_name(rec.entries())
    wait, front = e["issue.wait"][0], e["issue.front"][0]
    assert seen["rid"] == 11 and seen["span"] == front.id and seen["thread"] == front.thread
    assert wait.thread == threading.get_native_id() != front.thread
    assert wait.rid == front.rid == 11 and wait.cause == front.cause == req.id
    assert wait.start <= wait.end <= front.start <= front.end
    names = rec.thread_names()            # each thread named by itself, not by who recorded for it
    assert names[wait.thread] == threading.current_thread().name
    assert names[front.thread].startswith("zv-launch")
    # called from the issuing thread itself, fn runs inline and is recorded all the same
    inline = on_issuing_thread("cpu", lambda: on_issuing_thread("cpu", fn, 2, span="issue.vocode"))
    assert inline == 3 and _by_name(rec.entries())["issue.vocode"][0].thread == front.thread


def test_request_ids_cross_the_batcher(rec, params):
    engine = TTSEngine(params, CFG, mel_buckets=(16, 32), device="cpu")
    engine.warmup(batch=engine.batch_ladder[-1])
    b = DynamicBatcher(engine, window_ms=1.0)
    lens = {}
    try:
        def one(k):
            with profiling.span("daemon.request", rid=100 + k):
                _, lens[100 + k] = b.synthesize(*_utt(k, n=6 + k))

        threads = [threading.Thread(target=one, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        b.stop()
    e = _by_name(rec.entries())
    dispatches = {d.id: d for d in e["batcher.dispatch"]}
    assert sorted(r for d in dispatches.values() for r in d.rid) == [100, 101, 102]
    requests = {r.rid: r for r in e["daemon.request"]}
    for q in e["batcher.queue"]:
        assert q.cause in dispatches and q.rid in dispatches[q.cause].rid
        assert q.thread == requests[q.rid].thread and q.start <= q.end
    for f in e["batcher.fetch"]:
        assert f.cause in dispatches and f.rid == dispatches[f.cause].rid
    fetches = {f.id: f for f in e["batcher.fetch"]}
    for f in fetches.values():               # counted in fetch(), for the dispatch's requests:
        counted = [c for c in e["vocoder.frames"] if c.cause == f.id]   # each row at its bucket
        assert counted and all(c.rid == f.rid for c in counted)
        assert sum(c.a for c in counted) == sum(lens[r] for r in f.rid)
        assert sum(c.b for c in counted) == sum(engine.pick_bucket(lens[r]) for r in f.rid)
    # the fronts are issued by the dispatch, the vocoders in one "issue.collect"
    # run by the fetch that read mel_len
    collects = {c.id: c for c in e["issue.collect"]}
    for name, causes in (("issue.front", dispatches), ("issue.collect", fetches),
                         ("issue.vocode", collects)):
        issued = [x for x in e[name] if x.rid is not None]          # not the warm-up's
        assert issued and {x.cause for x in issued} <= set(causes)
        assert all(x.rid == causes[x.cause].rid for x in issued)


# ------------------------------------------------------------------ the daemon

@pytest.fixture(scope="module")
def daemon(params):
    """A batching daemon on a fresh recorder (the process's is put back after)."""
    with pytest.MonkeyPatch.context() as mp:
        r = profiling.SpanRecorder()
        mp.setattr(profiling, "RECORDER", r)
        s = TTSServer(params, CFG, port=0, warmup=True, chunk_frames=16, overlap=8,
                      batch_window_ms=5.0, max_batch=4, device="cpu")
        s.start()
        try:
            yield s, r
        finally:
            s.shutdown()


def _request(server, method, path, body=None):
    c = http.client.HTTPConnection(*server.address, timeout=TIMEOUT)
    try:
        c.request(method, path, body, {"Content-Type": "application/json"} if body else {})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _body(seed, n):
    src, pun, style, _ = _utt(seed, n)
    return {"phonemes": src[0, :n].tolist(), "puncts": pun[0, :n].tolist(),
            "style": style[0].tolist()}


def _requests(rec, endpoint):
    return [e for e in rec.entries() if e.name == "daemon.request" and e.a == endpoint]


def _post(server, rec, path, body):
    """(status, answer, the request's daemon.request entry).  The span ends
    after the answer is written, so the client may read the answer first:
    wait for it."""
    before = len(_requests(rec, path))
    status, answer = _request(server, "POST", path, json.dumps(body).encode())
    deadline = time.monotonic() + TIMEOUT
    while len(_requests(rec, path)) == before and time.monotonic() < deadline:
        time.sleep(0.01)
    return status, answer, _requests(rec, path)[-1]


def _tree(rec, req):
    """The names recorded for request `req`."""
    return {e.name for e in rec.entries() if spans.serves(e, req.rid)}


def test_warmup_is_recorded(daemon):
    s, rec = daemon
    assert rec.on
    t = rec.totals()
    assert {"daemon.warmup", "warmup.engine", "warmup.stream"} <= set(t)
    e = _by_name(rec.entries())
    warm = e["daemon.warmup"][0]
    assert {x.cause for x in e["warmup.engine"] + e["warmup.stream"]} == {warm.id}
    assert t["daemon.warmup"]["total_ns"] >= t["warmup.engine"]["total_ns"] + \
        t["warmup.stream"]["total_ns"]


def test_daemon_span_trees(daemon):
    s, rec = daemon
    status, _, req = _post(s, rec, "/synthesize", _body(1, 9))
    assert status == 200
    assert _tree(rec, req) == {"daemon.request", "daemon.read", "batcher.queue", "batcher.dispatch",
                     "issue.wait", "issue.front", "issue.collect", "issue.vocode",
                     "batcher.fetch", "engine.sync", "vocoder.frames", "vocoder.groups",
                     "daemon.encode", "daemon.write"}
    deadline = time.monotonic() + TIMEOUT
    while True:                      # /metrics records the request right after its span
        ep = json.loads(_request(s, "GET", "/metrics")[1])["endpoints"]["/synthesize"]
        if ep["count"] >= len(_requests(rec, "/synthesize")) or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert ep["max_ms"] >= round((req.end - req.start) / 1e6, 3) > 0   # /metrics' timer is the span

    body = {"utterances": [_body(2, 5), _body(3, 12), _body(4, 16)]}
    status, answer, req = _post(s, rec, "/batch", body)
    assert status == 200
    names = _tree(rec, req)
    assert names == {"daemon.request", "daemon.read", "issue.wait", "issue.front",
                     "engine.sync", "issue.collect", "issue.vocode", "vocoder.frames",
                     "vocoder.groups", "daemon.encode", "daemon.write"}
    mine = [e for e in rec.entries() if e.rid == req.rid]
    handler = {e.name for e in mine if e.thread == req.thread}
    # the rest on the issuing thread
    assert handler == names - {"issue.front", "issue.collect", "issue.vocode"}
    assert all(req.start <= e.start <= e.end <= req.end for e in mine)
    mel_len = json.loads(answer)["mel_len"]
    frames = [e for e in mine if e.name == "vocoder.frames"]
    assert sum(e.a for e in frames) == sum(mel_len)
    # the vocoder runs a chunk's real rows (1 up to the ladder top) at a bucket
    sizes = {r * bk for r in range(1, s.engine.batch_ladder[-1] + 1)
             for bk in s.engine.mel_buckets}
    assert frames and all(e.b in sizes and e.b >= e.a for e in frames)


def test_trace_endpoint_in_both_forms(daemon):
    s, rec = daemon
    assert _post(s, rec, "/synthesize", _body(5, 7))[0] == 200
    status, raw = _request(s, "GET", "/trace")
    assert status == 200
    got = json.loads(raw)
    assert got["clock"] == profiling.CLOCK == "time.time_ns" and got["on"] is True
    assert got["fields"] == list(profiling.Entry._fields)
    req = got["totals"]["daemon.request"]
    assert req["count"] >= 1 and req["total_ns"] > 0 and req["p95_ms"] >= req["p50_ms"] > 0
    assert got["totals"]["vocoder.frames"]["b"] >= max(1, got["totals"]["vocoder.frames"]["a"])
    names = {e[0] for e in got["entries"]}
    assert {"daemon.request", "batcher.dispatch", "vocoder.frames"} <= names

    status, raw = _request(s, "GET", "/trace?format=chrome")
    assert status == 200
    chrome = json.loads(raw)
    base = chrome["baseTimeNanoseconds"]
    events = chrome["traceEvents"]
    spans_ = [e for e in events if e["ph"] == "X" and e["name"] == "daemon.request"]
    counters = [e for e in events if e["ph"] == "C" and e["name"] == "vocoder.frames"]
    assert spans_ and counters and any(e["ph"] == "M" for e in events)
    first = next(e for e in rec.entries() if e.name == "daemon.request")
    assert any(abs(e["ts"] - (first.start - base) / 1e3) < 1e-3 for e in spans_)
    assert 0 < base <= time.time_ns()


def test_span_and_profiler_share_a_clock(rec):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("sum") as s:
            torch.ones(8).sum()
    trace = reduce_events(prof.profiler.kineto_results.events(), (s.start - 10**9, s.end + 10**9))
    sums = [e for e in trace.host_ops if e.name == "aten::sum"]
    assert sums and all(s.start <= e.start <= e.end <= s.end for e in sums)


# ----------------------------------------------------------------- the readers

def _ctx(window, device=()):
    return SimpleNamespace(trace=TraceData(window, [Event("k", a, b) for a, b in device], [], []))


def _read(name, ctx):
    return spec.reader("metrics", name)(ctx)


def test_vocoder_fill_readers(rec):
    for t, needed, vocoded in ((900, 1, 100), (1100, 3360, 12000), (1500, 4000, 12000),
                               (2000, 1, 100)):
        rec.add("vocoder.frames", t, t, rec.new_id(), a=needed, b=vocoded)
    rec.add("other", 1200, 1300, rec.new_id(), a=5, b=6)
    ctx = _ctx((1000, 2000))
    assert _read("vocoder.fill", ctx) == pytest.approx(100 * 7360 / 24000)
    assert _read("vocoder.fill.card", ctx) == _read("vocoder.fill", ctx)
    assert _read("vocoder.fill", _ctx((3000, 4000))) is None


def test_daemon_self_ms_reader(rec):
    ms = 10**6
    add = lambda name, s, e, rid, a=None, th=1: rec.add(name, s * ms, e * ms, rec.new_id(),  # noqa
                                                        rid, None, a, None, th)
    add("daemon.request", 110, 190, 1, "/batch")
    add("issue.wait", 115, 120, 1)
    add("issue.front", 120, 140, 1, th=2)
    add("engine.sync", 140, 150, 1)
    add("issue.vocode", 150, 170, 1, th=2)
    add("engine.sync", 168, 180, 1)               # overlapping waits counted once
    add("daemon.encode", 180, 185, 1)             # the handler's own work: not subtracted
    add("issue.front", 185, 189, 2, th=2)         # another request's
    add("daemon.request", 100, 150, 3, "/batch")
    add("engine.sync", 105, 145, 3)
    add("daemon.request", 120, 130, 4, "/synthesize")
    add("daemon.request", 150, 260, 5, "/batch")  # ends after the window
    ctx = _ctx((120 * ms, 200 * ms))
    # request 1: 80 ms less 65 ms of waits; request 3: 50 less 40
    assert _read("daemon.self_ms", ctx) == pytest.approx((15 + 10) / 2)
    assert _read("daemon.self_ms", _ctx((300 * ms, 400 * ms))) is None


def test_front_issue_ms_reader(rec):
    ms = 10**6
    for s, e in ((100, 102), (105, 109), (190, 220)):
        rec.add("issue.front", s * ms, e * ms, rec.new_id())
    rec.add("issue.vocode", 110 * ms, 150 * ms, rec.new_id())
    assert _read("front.issue_ms", _ctx((100 * ms, 200 * ms))) == pytest.approx(3.0)
    assert _read("front.issue_ms", _ctx((300 * ms, 400 * ms))) is None


def test_device_idle_issuing_reader(rec):
    for name, s, e in (("issue.front", 100, 300), ("issue.vocode", 250, 400),
                       ("issue.stream", 600, 700), ("issue.wait", 400, 600),
                       ("engine.sync", 700, 900), ("issue.front", 950, 1100)):
        rec.add(name, s, e, rec.new_id())
    ctx = _ctx((0, 1000), device=[(0, 150), (350, 650), (980, 990)])
    # launching while the card is idle: 150-350, 650-700, 950-980, 990-1000
    assert _read("device.idle_issuing", ctx) == pytest.approx(100 * (200 + 50 + 30 + 10) / 1000)
    assert _read("device.idle_issuing", _ctx((0, 1000))) is None          # no device event
    assert _read("device.idle_issuing", _ctx((2000, 3000), [(2000, 2100)])) is None


def test_daemon_warmup_s_reader(rec):
    assert _read("daemon.warmup_s", _ctx((0, 1))) is None
    profiling.record("daemon.warmup", 0, 2_500_000_000)
    rec.add("daemon.warmup", 0, 0, rec.new_id())            # a second warm-up adds to the total
    assert _read("daemon.warmup_s", _ctx((0, 1))) == pytest.approx(2.5)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_a_recorder(monkeypatch, name):
    """A program without the recorder (its profiling module has no
    RECORDER): every reader returns None and raises nothing."""
    monkeypatch.delattr(profiling, "RECORDER")
    assert spans.recorder() is None and spans.ring() is None and spans.totals() is None
    assert _read(name, _ctx((0, 10**9), device=[(0, 10)])) is None
