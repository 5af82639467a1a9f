"""The port's dynamic request batching (runtime/batcher.py) on the CPU.

The counterpart of tests/test_batcher.py: concurrent one-shot requests
coalesce into packed dispatches whose per-utterance results equal the
unbatched engine's (float32 on the CPU: within 1e-6, and equal PCM16 to
1 LSB; bfloat16: 2 bf16 ulps at the top of [-1, 1], the tolerance of
synthesize_async against synthesize in tests/test_torch_pipeline.py),
failures reach every waiter, and the daemon exposes the batcher's counts.
"""

import http.client
import itertools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.runtime.batcher import DynamicBatcher
from zerovox_tpu_torch.runtime.client import parse_wav_bytes
from zerovox_tpu_torch.runtime.engine import TTSEngine, _Rows
from zerovox_tpu_torch.runtime.server import TTSServer
from zerovox_tpu_torch.utils import profiling

CFG = TINY_CONFIG
JSON = {"Content-Type": "application/json"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """TINY-size ops gain nothing from intra-op threads, and several test
    workers' thread pools spinning on the same cores cost a lot."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return tparams.init_params(CFG, seed=0, device="cpu")


@pytest.fixture(scope="module")
def engine(params):
    e = TTSEngine(params, CFG, mel_buckets=(16, 32), device="cpu")
    e.warmup(batch=e.batch_ladder[-1])
    return e


def _utt(rng, n=None):
    P = CFG.max_n_phonemes
    return (rng.integers(1, CFG.num_phonemes, size=(1, P)).astype(np.int32),
            rng.integers(0, CFG.num_puncts, size=(1, P)).astype(np.int32),
            rng.normal(scale=0.1, size=(1, CFG.d_model)).astype(np.float32),
            np.asarray([P if n is None else n], np.int32))


@pytest.fixture
def rec(monkeypatch):
    """A fresh span recorder in the process recorder's place, on."""
    r = profiling.SpanRecorder(size=1 << 12)
    monkeypatch.setattr(profiling, "RECORDER", r)
    r.on = True
    return r


def _rows(rng, lengths):
    """One batch of utterances with these phoneme counts."""
    return [np.concatenate(a) for a in zip(*(_utt(rng, n) for n in lengths))]


def _named(rec, name):
    return [e for e in rec.entries() if e.name == name]


class _Wrapped:
    """An engine whose dispatch (synthesize_async) and fetch can be made slow,
    which makes coalescing deterministic: the delay holds the dispatcher
    thread inside synthesize_async, so requests submitted meanwhile are
    queued when it comes back.  `entered` is set when a dispatch begins."""

    def __init__(self, engine, dispatch_s=0.0, fetch_s=0.0):
        self._engine, self._dispatch_s, self._fetch_s = engine, dispatch_s, fetch_s
        self.entered = threading.Event()
        self.batch_sizes = []
        self.log = []                       # (what, when), appended from several threads

    @property
    def batch_ladder(self):
        return self._engine.batch_ladder

    def row_ladder_sizes(self, n):
        return self._engine.row_ladder_sizes(n)

    def synthesize_async(self, src, *a, **kw):
        self.entered.set()
        self.batch_sizes.append(len(src))
        self.log.append(("dispatch", time.perf_counter()))
        time.sleep(self._dispatch_s)
        inner = self._engine.synthesize_async(src, *a, **kw)

        def fetch():
            self.log.append(("fetch begins", time.perf_counter()))
            time.sleep(self._fetch_s)
            self.log.append(("fetch ends", time.perf_counter()))
            return inner()

        return fetch


def _run_threads(fn, n, timeout=120):
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def worker(i):
        try:
            barrier.wait(timeout=timeout)
            results[i] = fn(i)
        except Exception as e:          # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()
    assert not errors, errors
    return results


@pytest.mark.parametrize("pcm16", [False, True])
def test_concurrent_requests_coalesce_and_match(engine, pcm16):
    """4 threads submit together: after the first (possibly lone) dispatch
    the rest coalesce during its in-flight run; every result equals the
    unbatched engine's output for that utterance (mixed lengths)."""
    rng = np.random.default_rng(0)
    utts = [_utt(rng, n) for n in (16, 11, 7, 16)]
    refs = [engine.synthesize(*u, pcm16=pcm16) for u in utts]
    slow = _Wrapped(engine, dispatch_s=0.5)
    b = DynamicBatcher(slow, window_ms=50.0)
    try:
        results = _run_threads(lambda i: b.synthesize(*utts[i], pcm16=pcm16), 4)
        for (wav, mel_len), (ref_wavs, ref_len) in zip(results, refs):
            assert mel_len == int(ref_len[0]) and wav.dtype == ref_wavs[0].dtype
            assert wav.shape == ref_wavs[0].shape
            np.testing.assert_allclose(wav, ref_wavs[0], atol=1 if pcm16 else 1e-6, rtol=0)
        stats = b.snapshot()
        assert stats["requests"] == 4 and stats["max_batch"] >= 2 and stats["dispatches"] < 4
        assert sum(slow.batch_sizes) == 4 and max(slow.batch_sizes) == stats["max_batch"]
    finally:
        b.stop()


@pytest.mark.parametrize("ladder, max_batch", [((1, 2, 4, 8), None), ((1, 2), 4)])
def test_batcher_reports_the_dispatched_batch_size(params, ladder, max_batch):
    """synthesize_sized() adds the batch size the request was computed at, as
    the engine reports it (row_ladder_sizes), also where a dispatch passes
    the ladder top and its chunks run at different sizes: the sizes the
    fronts ran at; each answer equals the engine's own at that batch size
    (the first row repeated, as the ladder pads) bit for bit."""
    engine = TTSEngine(params, CFG, mel_buckets=(16, 32), batch_ladder=ladder, device="cpu")
    fronts, front = [], engine._front
    engine._front = lambda src, *a: fronts.append(len(src)) or front(src, *a)
    rng = np.random.default_rng(5)
    utt = _utt(rng, 13)
    slow = _Wrapped(engine, dispatch_s=0.5)
    b = DynamicBatcher(slow, window_ms=50.0, max_batch=max_batch)
    try:
        first = []                  # a lone dispatch, and 3 requests queued behind it
        t = threading.Thread(target=lambda: first.append(b.synthesize_sized(*utt, pcm16=True)))
        t.start()
        assert slow.entered.wait(timeout=30)
        results = _run_threads(lambda i: b.synthesize_sized(*utt, pcm16=True), 3)
        t.join(timeout=60)
        results += first
        reported = [s for n in slow.batch_sizes for s in engine.row_ladder_sizes(n)]
        assert sorted(r[2] for r in results) == sorted(reported)
        assert set(reported) == set(fronts)
        assert slow.batch_sizes == [1, 3] and len(results) == 4
        for wav, mel_len, size in results:
            rows = [np.repeat(a, size, axis=0) for a in utt]
            ref, ref_len = engine.synthesize_async(*rows, pcm16=True)()
            assert mel_len == int(ref_len[0])
            np.testing.assert_array_equal(wav, ref[0])
        lone = b.synthesize_sized(*utt, pcm16=True)
        assert lone[2] == 1 and len(b.synthesize(*utt, pcm16=True)) == 2
    finally:
        b.stop()


def test_batched_bf16_matches_direct(params):
    """The serving dtype through the batcher: batch members run at another
    batch size and bucket than the direct call, so sums may round the other
    way: 2 bf16 ulps at the top of [-1, 1]."""
    engine = TTSEngine(params, CFG, precision="bfloat16", device="cpu")
    rng = np.random.default_rng(8)
    utts = [_utt(rng) for _ in range(3)]
    refs = [engine.synthesize(*u) for u in utts]
    b = DynamicBatcher(_Wrapped(engine, dispatch_s=0.2), window_ms=50.0)
    try:
        results = _run_threads(lambda i: b.synthesize(*utts[i]), 3)
        for (wav, mel_len), (ref_wavs, ref_len) in zip(results, refs):
            assert mel_len == int(ref_len[0])
            np.testing.assert_allclose(wav, ref_wavs[0], rtol=0, atol=2 * 2.0 ** -8)
        assert b.snapshot()["max_batch"] >= 2
    finally:
        b.stop()


# 10 rows in two ladder chunks, at the TINY engine's grid 16, 32, 64 (a
# phoneme lasts 2 frames, the margin is 8): the first chunk's rows reach all
# three buckets, the second's 32 and 16, so the bucket groups 16 (7 rows),
# 32 (2) and 64 (1) each take rows from both chunks or from the middle of one
SPLIT_LENGTHS = (4, 3, 2, 1, 4, 12, 16, 1, 11, 2)
SPLIT_GROUPS = {16: [0, 1, 2, 3, 4, 7, 9], 32: [5, 8], 64: [6]}


def _alone(engine, src, pun, sty, n, pcm16=False):
    """Each row's answer with its mel (from the same fronts: a front's answer
    can depend on its batch size) vocoded on its own, at its bucket."""
    _, fronts = engine._issue_fronts(src, pun, sty, n)
    mels = tuple(mel for mel, _, _ in fronts)
    lens = np.concatenate([lens.numpy()[:k] for _, (lens, _), k in fronts])
    return [engine._vocode(_Rows(mels, [i], engine.pick_bucket(int(L))), pcm16)[0].numpy()
            [:int(L) * CFG.hop_size] for i, L in enumerate(lens)]


def test_async_issues_the_vocoder_in_fetch(engine, rec):
    """synthesize_async issues the fronts alone and waits for nothing:
    no "issue.vocode" span and no "engine.sync" before fetch() is called;
    fetch() issues one vocoder per bucket group (three, across the two
    ladder chunks)."""
    src, pun, sty, n = _rows(np.random.default_rng(11), SPLIT_LENGTHS)
    fetch = engine.synthesize_async(src, pun, sty, n)
    assert len(_named(rec, "issue.front")) == 2
    assert _named(rec, "issue.vocode") == [] and _named(rec, "engine.sync") == []
    wavs, lens = fetch()
    assert engine.group_by_bucket(lens) == SPLIT_GROUPS
    assert len(_named(rec, "issue.vocode")) == 3 and len(wavs) == len(lens) == 10


@pytest.mark.parametrize("pcm16", [False, True])
def test_async_vocodes_each_chunk_at_its_bucket(engine, rec, pcm16):
    """Each row vocodes at its own bucket, with the rows of its bucket from
    every ladder chunk, read from the "vocoder.frames" counters (b == rows x
    bucket), not at its chunk's longest row's bucket nor at max_seq_len; the
    answers equal each row's vocoded alone (f32 within 1e-6, PCM16
    within 1 LSB)."""
    src, pun, sty, n = _rows(np.random.default_rng(12), SPLIT_LENGTHS)
    want = _alone(engine, src, pun, sty, n, pcm16)
    before = len(_named(rec, "vocoder.frames"))
    got, got_len = engine.synthesize_async(src, pun, sty, n, pcm16=pcm16)()
    frames = _named(rec, "vocoder.frames")[before:]
    assert engine.group_by_bucket(got_len) == SPLIT_GROUPS
    assert [(f.a, f.b) for f in frames] == [(int(got_len[rows].sum()), len(rows) * b)
                                            for b, rows in SPLIT_GROUPS.items()]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1 if pcm16 else 1e-6)


@pytest.mark.parametrize("pcm16", [False, True])
def test_dispatch_in_three_buckets_vocodes_each_at_its_own(engine, rec, monkeypatch, pcm16):
    """A dispatch (one ladder chunk, as the batcher makes) whose rows reach
    three buckets makes three vocoder calls, each at its bucket and its real
    rows, as "vocoder.frames" counts them and the vocoder's inputs show; each
    answer equals the row's vocoded alone (f32 within 1e-6, PCM16
    within 1 LSB)."""
    shapes = _vocoder_rows(monkeypatch)
    src, pun, sty, n = _rows(np.random.default_rng(17), (2, 9, 16, 3, 12))
    want = _alone(engine, src, pun, sty, n, pcm16)
    del shapes[:]
    before = len(_named(rec, "vocoder.frames"))
    got, got_len = engine.synthesize_async(src, pun, sty, n, pcm16=pcm16)()
    groups = {16: [0, 3], 32: [1, 4], 64: [2]}
    assert engine.group_by_bucket(got_len) == groups
    assert shapes == [(len(rows), b, CFG.num_mels) for b, rows in groups.items()]
    frames = _named(rec, "vocoder.frames")[before:]
    assert [(f.a, f.b) for f in frames] == [(int(got_len[rows].sum()), len(rows) * b)
                                            for b, rows in groups.items()]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1 if pcm16 else 1e-6)


@pytest.mark.parametrize("lengths, trim, counted", [
    ((7,), True, (1, 1)),                          # one row: one group, one chunk
    ((2, 9, 16, 3, 12), True, (3, 1)),             # one chunk split in three buckets
    (SPLIT_LENGTHS, True, (3, 2)),                 # three buckets over two chunks
    (SPLIT_LENGTHS, False, (2, 2)),                # untrimmed: each chunk whole
])
def test_vocoder_groups_counts_calls_and_chunks(engine, rec, lengths, trim, counted):
    """One "vocoder.groups" counter per engine call: the vocoder calls it
    made and the ladder chunks its fronts ran in."""
    engine.synthesize_async(*_rows(np.random.default_rng(18), lengths), trim=trim)()
    (groups,) = _named(rec, "vocoder.groups")
    assert (groups.a, groups.b) == counted
    assert groups.a == len(_named(rec, "vocoder.frames"))


def test_vocoder_rows_are_selected_on_the_issuing_thread(engine, monkeypatch):
    """fetch() selects the vocoder's rows (here runs from two chunks and
    from the middle of one) inside the issued vocode, on the issuing thread,
    with no index tensor copied from the host; a group of one chunk's first
    rows is a view of its mel."""
    from zerovox_tpu_torch.runtime import engine as engine_module
    issuing, selecting, copying = set(), set(), []
    issue = engine_module.on_issuing_thread

    def spied(device, fn, *a, **kw):
        def run(*x, **y):
            issuing.add(threading.get_ident())
            return fn(*x, **y)
        return issue(device, run, *a, **kw)

    mel_rows = TTSEngine._mel_rows
    monkeypatch.setattr(engine_module, "on_issuing_thread", spied)
    monkeypatch.setattr(TTSEngine, "_mel_rows", lambda self, *a: (
        selecting.add(threading.get_ident()), mel_rows(self, *a))[1])
    fetch = engine.synthesize_async(*_rows(np.random.default_rng(19), SPLIT_LENGTHS))
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda *a, **kw: (
        "device" in kw and copying.append(threading.get_ident()), as_tensor(*a, **kw))[1])
    issuing.clear()
    _, lens = fetch()
    assert engine.group_by_bucket(lens) == SPLIT_GROUPS
    assert selecting and selecting <= issuing and threading.get_ident() not in issuing
    assert set(copying) <= issuing
    mel = torch.zeros((8, CFG.max_seq_len, CFG.num_mels))
    assert mel_rows(engine, (mel,), [0, 1, 2])._base is mel
    np.testing.assert_array_equal(mel_rows(engine, (mel, mel + 1), [1, 9, 2]).numpy(),
                                  np.stack([mel[1].numpy(), mel[1].numpy() + 1, mel[2].numpy()]))


def _vocoder_rows(monkeypatch):
    """The (rows, frames, mels) of every vocode from here on."""
    from zerovox_tpu_torch.models import hifigan
    shapes = []
    vocode = hifigan.vocode
    monkeypatch.setattr(hifigan, "vocode",
                        lambda p, c, mel, *a, **kw: shapes.append(tuple(mel.shape)) or
                        vocode(p, c, mel, *a, **kw))
    return shapes


def test_async_vocodes_the_real_rows(engine, rec, monkeypatch):
    """A chunk of 3 requests runs its front at the ladder's 4 rows and its
    vocoder at each bucket's real rows, 2 at 32 and 1 at 16
    ("vocoder.frames" b == rows x bucket, the vocoder's inputs); the answers
    equal each row's vocoded alone (f32 within 1e-6: the same per-row
    arithmetic); warmup() ran those shapes."""
    shapes = _vocoder_rows(monkeypatch)
    engine.warmup(batch=engine.batch_ladder[-1])
    warmed = set(shapes)
    src, pun, sty, n = _rows(np.random.default_rng(15), (5, 3, 9))
    want = _alone(engine, src, pun, sty, n)
    del shapes[:]
    got, got_len = engine.synthesize_async(src, pun, sty, n)()
    frames = _named(rec, "vocoder.frames")[-2:]
    groups = engine.group_by_bucket(got_len)
    assert groups == {32: [0, 2], 16: [1]}
    assert shapes == [(2, 32, CFG.num_mels), (1, 16, CFG.num_mels)] and set(shapes) <= warmed
    assert [(f.a, f.b) for f in frames] == [(int(got_len[r].sum()), len(r) * b)
                                            for b, r in groups.items()]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_warmup_runs_every_vocoder_row_count(engine, monkeypatch):
    """warmup() vocodes once at every row count up to the ladder top at
    every bucket (both output types from one vocode), and no shape twice."""
    shapes = _vocoder_rows(monkeypatch)
    engine.warmup(batch=engine.batch_ladder[-1], pcm16=True)
    top = engine.batch_ladder[-1]
    assert sorted(shapes) == sorted((r, b, CFG.num_mels) for r in range(1, top + 1)
                                    for b in engine.mel_buckets)


def test_warmup_covers_every_bucket_grouping(engine, monkeypatch):
    """Every vocoder shape that the bucket grouping of a call of up to the
    ladder top's rows can make, over every mix of the rows' buckets, is one
    warmup() ran, and warmup() runs no other: the groups add no shape and
    no set-up."""
    from zerovox_tpu_torch.models import hifigan
    shapes = []
    monkeypatch.setattr(hifigan, "vocode", lambda p, c, mel, *a, **kw: (
        shapes.append(tuple(mel.shape)), torch.zeros(mel.shape[0], mel.shape[1] * c.hop_size))[1])
    engine.warmup(batch=engine.batch_ladder[-1])
    warmed = set(shapes)
    del shapes[:]
    top = engine.batch_ladder[-1]
    for k in range(1, top + 1):
        for buckets in itertools.combinations_with_replacement(engine.mel_buckets, k):
            mel = torch.zeros((engine.ladder_size(k), CFG.max_seq_len, CFG.num_mels))
            lens = torch.tensor([b - engine.margin for b in buckets])
            _, got = engine._collect(engine._models, [(mel, (lens, None), k)], True, False)
            assert [engine.pick_bucket(x) for x in got] == list(buckets)
    assert set(shapes) == warmed


@pytest.mark.parametrize("path", ["synthesize", "synthesize_packed", "synthesize_async"])
def test_every_path_vocodes_the_real_rows(engine, rec, monkeypatch, path):
    """Every batched path vocodes each bucket group's real rows (5 requests:
    fronts at the ladder's 8, vocoders per bucket group at its own count),
    as "vocoder.frames" counts them."""
    shapes = _vocoder_rows(monkeypatch)
    src, pun, sty, n = _rows(np.random.default_rng(16), (5, 3, 9, 4, 12))
    call = getattr(engine, path)(src, pun, sty, n)
    _, lens = call() if path == "synthesize_async" else call
    groups = {b: len(ix) for b, ix in engine.group_by_bucket(lens).items()}
    assert groups == {32: 3, 16: 2}
    assert sorted(s[:2] for s in shapes) == sorted((r, b) for b, r in groups.items())
    frames = _named(rec, "vocoder.frames")[-len(groups):]
    assert sorted(f.b for f in frames) == sorted(b * r for b, r in groups.items())


def test_async_untrimmed_vocodes_at_the_largest_bucket(engine, rec):
    """trim=False promises the full padded buffer: every chunk still vocodes
    at mel_buckets[-1], and the answers equal synthesize(trim=False)'s."""
    src, pun, sty, n = _rows(np.random.default_rng(13), SPLIT_LENGTHS)
    got, got_len = engine.synthesize_async(src, pun, sty, n, trim=False)()
    frames = _named(rec, "vocoder.frames")
    assert [f.b for f in frames] == [8 * CFG.max_seq_len, 2 * CFG.max_seq_len]
    want, want_len = engine.synthesize(src, pun, sty, n, trim=False)
    np.testing.assert_array_equal(got_len, want_len)
    for a, b in zip(got, want):
        assert a.shape == (CFG.wav_len,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_batcher_vocodes_on_the_completion_pool(engine, rec):
    """Through the batcher the dispatch issues fronts only: every
    "issue.vocode" runs in an "issue.collect" caused by a "batcher.fetch",
    none by a dispatch, and the dispatcher thread records no
    "engine.sync"."""
    b = DynamicBatcher(engine, window_ms=1.0)
    try:
        rng = np.random.default_rng(14)
        _run_threads(lambda i: b.synthesize(*_utt(rng, 2 + i)), 3)
    finally:
        b.stop()
    dispatches = _named(rec, "batcher.dispatch")
    fetches = {f.id for f in _named(rec, "batcher.fetch")}
    collects = {c.id: c for c in _named(rec, "issue.collect")}
    vocodes = _named(rec, "issue.vocode")
    assert dispatches and vocodes and {v.cause for v in vocodes} <= set(collects)
    assert {c.cause for c in collects.values()} <= fetches
    dispatcher = {d.thread for d in dispatches}
    assert not [s for s in _named(rec, "engine.sync") if s.thread in dispatcher]


def test_idle_request_dispatches_immediately(engine):
    """A lone request on an idle batcher does not wait out the window.  Idle
    means that the dispatcher found its queue empty and went to sleep: on the
    CPU a dispatch computes before it returns, so the first answer can arrive
    a moment before the dispatcher is back at its queue."""
    b = DynamicBatcher(engine, window_ms=2000.0)
    try:
        utt = _utt(np.random.default_rng(4))
        b.synthesize(*utt)
        time.sleep(0.1)
        t0 = time.perf_counter()
        b.synthesize(*utt)
        lone = time.perf_counter() - t0
        assert lone < 1.8, lone                    # under the 2 s window
        assert b.snapshot() == {"dispatches": 2, "requests": 2, "max_batch": 1}
    finally:
        b.stop()


def test_dispatch_and_fetch_pipeline(engine):
    """Dispatch and fetch are pipelined: the dispatcher hands fetch() to the
    completion pool and dispatches the next batch at once, so a second
    request's dispatch begins while the first one's (slow) fetch is still
    running, and both fetches overlap."""
    slow = _Wrapped(engine, fetch_s=0.6)
    b = DynamicBatcher(slow, window_ms=1.0)
    try:
        rng = np.random.default_rng(5)
        u1, u2 = _utt(rng), _utt(rng)
        b.synthesize(*u1)                        # warm + prime the pool
        slow.log.clear()
        results = [None, None]

        def worker(i, u):
            results[i] = b.synthesize(*u)

        t1 = threading.Thread(target=worker, args=(0, u1))
        t1.start()
        time.sleep(0.1)                          # let dispatch 1 be taken alone
        t2 = threading.Thread(target=worker, args=(1, u2))
        t2.start()
        t1.join(timeout=60)
        t2.join(timeout=60)
        assert all(r is not None for r in results)
        assert b.snapshot()["dispatches"] >= 3
        events = [name for name, _ in sorted(slow.log, key=lambda e: e[1])]
        # serial would be dispatch, fetch begins, fetch ends, dispatch, ...: here the
        # second dispatch and the second fetch both begin before the first fetch ends
        # (a loaded machine may start the first fetch after the second dispatch)
        assert sorted(events) == ["dispatch"] * 2 + ["fetch begins"] * 2 + ["fetch ends"] * 2
        assert events[0] == "dispatch" and events[4:] == ["fetch ends"] * 2, events
    finally:
        b.stop()


def test_timeout_dequeue_mid_window_keeps_dispatcher_alive(engine):
    """A request that hits its timeout and dequeues itself while the
    dispatcher is inside the fill window leaves _take_batch returning an
    empty batch with stop unset; the dispatcher treats that as spurious and
    keeps serving."""
    gated = _Wrapped(engine, dispatch_s=0.3)
    b = DynamicBatcher(gated, window_ms=1500.0, request_timeout_s=0.6)
    try:
        rng = np.random.default_rng(6)
        uA, uB, uC = _utt(rng), _utt(rng), _utt(rng)
        res_a = {}
        t = threading.Thread(target=lambda: res_a.update(r=b.synthesize(*uA)))
        t.start()
        assert gated.entered.wait(timeout=30)     # the dispatcher is inside A's dispatch
        with pytest.raises(TimeoutError):         # B times out mid-window
            b.synthesize(*uB)
        t.join(timeout=60)
        assert "r" in res_a
        time.sleep(1.6)                           # the now-empty window expires
        assert b._thread.is_alive(), "dispatcher died on the empty batch"
        b.request_timeout_s = 60.0
        wav, mel_len = b.synthesize(*uC)
        ref_wavs, ref_len = engine.synthesize(*uC)
        assert mel_len == int(ref_len[0])
        np.testing.assert_allclose(wav, ref_wavs[0], atol=1e-6)
    finally:
        b.stop()


def test_batcher_propagates_failures(engine):
    """A dispatch failure reaches its waiter as a raised exception, not a
    hang, and the batcher goes on serving."""
    b = DynamicBatcher(engine, window_ms=1.0)
    try:
        rng = np.random.default_rng(1)
        src, pun, style, n = _utt(rng)
        with pytest.raises(Exception):
            b.synthesize(src, pun, np.zeros((1, CFG.d_model + 3), np.float32), n)
        wav, _ = b.synthesize(src, pun, style, n)
        assert len(wav) > 0
        assert b.snapshot()["dispatches"] == 2
    finally:
        b.stop()


def test_batcher_rejects_multi_utterance_and_use_after_stop(engine):
    b = DynamicBatcher(engine, window_ms=1.0)
    src, pun, style, n = _utt(np.random.default_rng(2))
    try:
        with pytest.raises(ValueError, match="B=1"):
            b.synthesize(np.repeat(src, 2, 0), np.repeat(pun, 2, 0),
                         np.repeat(style, 2, 0), np.repeat(n, 2))
    finally:
        b.stop()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        b.synthesize(src, pun, style, n)


def test_stop_drains_queued_requests(engine):
    """stop() while requests are queued behind a slow dispatch: they are
    still answered."""
    slow = _Wrapped(engine, dispatch_s=0.3)
    b = DynamicBatcher(slow, window_ms=20.0)
    rng = np.random.default_rng(3)
    utts = [_utt(rng) for _ in range(3)]
    results = [None] * 3
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, b.synthesize(*utts[i])))
               for i in range(3)]
    threads[0].start()
    assert slow.entered.wait(timeout=30)
    for t in threads[1:]:
        t.start()
    time.sleep(0.1)                               # the two are queued by now
    b.stop()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert all(r is not None and len(r[0]) > 0 for r in results)


def _post(address, path, body, header=None):
    """(status, body) of a POST; with `header`, that response header too."""
    c = http.client.HTTPConnection(*address, timeout=120)
    try:
        c.request("POST", path, body, JSON)
        r = c.getresponse()
        if header is not None:
            return r.status, r.read(), r.getheader(header)
        return r.status, r.read()
    finally:
        c.close()


def _json_utt(seed):
    rng = np.random.default_rng(seed)
    return json.dumps({
        "phonemes": rng.integers(1, CFG.num_phonemes, size=CFG.max_n_phonemes).tolist(),
        "puncts": rng.integers(0, CFG.num_puncts, size=CFG.max_n_phonemes).tolist(),
        "style": rng.normal(scale=0.05, size=CFG.d_model).astype(np.float32).tolist(),
    }).encode()


def test_server_batching_end_to_end(params):
    """Daemon with batch_window_ms: concurrent /synthesize POSTs all succeed,
    equal the direct engine's PCM16 to 1 LSB, and /metrics (JSON and
    Prometheus text) reports the coalescing."""
    s = TTSServer(params, CFG, port=0, warmup=True, chunk_frames=16, overlap=8,
                  batch_window_ms=50.0, device="cpu")
    s.batcher.engine = _Wrapped(s.engine, dispatch_s=0.3)
    s.start()
    try:
        body = _json_utt(3)
        results = _run_threads(
            lambda i: _post(s.address, "/synthesize?trim=0", body, "X-Batch-Size"), 3)
        direct = TTSServer(params, CFG, port=0, warmup=False, device="cpu")
        direct.start()
        try:
            status, raw, size = _post(direct.address, "/synthesize?trim=0", body, "X-Batch-Size")
        finally:
            direct.shutdown()
        want, rate = parse_wav_bytes(raw)
        assert status == 200 and rate == CFG.sampling_rate and size is None
        sizes = {s.engine.ladder_size(n) for n in s.batcher.engine.batch_sizes}
        for status, raw, size in results:
            assert status == 200 and int(size) in sizes      # the batch size it ran at
            got, _ = parse_wav_bytes(raw)
            assert got.shape == want.shape
            assert np.abs(got.astype(np.int32) - want).max() <= 1
        c = http.client.HTTPConnection(*s.address, timeout=60)
        c.request("GET", "/metrics")
        m = json.loads(c.getresponse().read())
        assert m["batcher"]["requests"] >= 3 and m["batcher"]["max_batch"] >= 2
        c.request("GET", "/metrics?format=prometheus")
        text = c.getresponse().read().decode()
        c.close()
        assert f"zerovox_batcher_max_batch {m['batcher']['max_batch']}" in text
    finally:
        s.shutdown()
    assert not s.batcher._thread.is_alive()          # shutdown stops the batcher


def test_server_soak_mixed_endpoints(params):
    """Soak: 8 clients x 12 mixed requests (synthesize / batch / stream /
    metrics / malformed) against a batching daemon: every response has the
    expected status, and the server leaks neither threads nor sockets."""
    s = TTSServer(params, CFG, port=0, warmup=True, chunk_frames=16, overlap=8,
                  batch_window_ms=10.0, max_batch=4, device="cpu")
    s.start()
    try:
        utt = _json_utt(7)
        batch_body = json.dumps({"utterances": [json.loads(utt)] * 2}).encode()
        plan = [("POST", "/synthesize", utt, 200), ("POST", "/batch", batch_body, 200),
                ("POST", "/stream", utt, 200), ("GET", "/metrics", None, 200),
                ("POST", "/synthesize", b"{]", 400), ("POST", "/nope", b"{}", 404)]

        def one(method, path, body):
            c = http.client.HTTPConnection(*s.address, timeout=120)
            try:
                if method == "GET":
                    c.request("GET", path)
                else:
                    c.request("POST", path, body, JSON)
                r = c.getresponse()
                r.read()
                return r.status
            finally:
                c.close()

        def client(i):
            bad = []
            for k in range(12):
                method, path, body, want = plan[(i + k) % len(plan)]
                status = one(method, path, body)
                if status != want:
                    bad.append((i, k, path, status, want))
            return bad

        def load_round():
            bad = [b for r in _run_threads(client, 8, timeout=300) for b in r]
            assert not bad, bad[:5]
            time.sleep(1.0)                         # let the handler threads retire
            return threading.active_count(), len(os.listdir("/proc/self/fd"))

        # a second round of the same load adds neither threads nor descriptors
        threads_before, fds_before = load_round()
        threads_after, fds_after = load_round()
        assert threads_after <= threads_before + 2, (threads_before, threads_after)
        assert fds_after <= fds_before + 8, (fds_before, fds_after)
        snap = s.batcher.snapshot()
        assert snap["requests"] >= 16 and snap["max_batch"] <= s.engine.batch_ladder[-1]
    finally:
        s.shutdown()
