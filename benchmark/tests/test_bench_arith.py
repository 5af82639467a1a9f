"""The yardstick's arithmetic on synthetic inputs: the end-to-end readers
over request logs, the trace reductions over intervals, the operation and
byte counts against PERF.md's hand-worked bounds."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import cupti, flops, spec, trace
from benchmark.check import answer_errors, expected_samples, verdict

MEDIUM = spec.cell("medium-bf16.serve-mixed-c16").config["model"]


def log(rows):
    return SimpleNamespace(records=rows, t_go=100.0, setup_s=12.5, sampling_rate=24000)


def row(t_send, t_first, t_done, samples, status=200):
    return {"t_send": t_send, "t_first": t_first, "t_done": t_done, "samples": samples,
            "status": status}


def test_audio_rate_counts_all_work_over_all_time():
    rows = [row(100.0, 100.1, 100.5, [24000]), row(100.5, 100.6, 101.0, [12000, 12000]),
            row(101.0, 101.1, 102.0, [48000])]
    # 4 s of audio between the window's start (100) and the last answer (102)
    assert spec.reader("end_to_end", "audio_s_per_s")(log(rows)) == pytest.approx(2.0)
    rows.append(row(102.0, None, 104.0, None, status=-1))       # a failure stretches the time
    assert spec.reader("end_to_end", "audio_s_per_s")(log(rows)) == pytest.approx(1.0)


def test_setup_and_an_empty_window():
    assert spec.reader("end_to_end", "setup_s")(log([])) == 12.5
    assert spec.reader("end_to_end", "audio_s_per_s")(log([row(100.0, None, 101.0, None,
                                                               status=-1)])) is None


def test_card_busy_from_activity_records():
    iv = [(100, 300), (200, 400), (600, 700), (650, 680)]
    assert cupti.busy_ns(iv, 0, 1000) == 400
    assert cupti.busy_ns(iv, 250, 650) == 150 + 50
    assert cupti.busy_ns([], 0, 1000) == 0
    c = cupti.Collector.__new__(cupti.Collector)
    c.error, c.intervals = None, {"kernel": iv[:2], "memset": iv[2:], "memcpy": [(0, 900)]}
    c._clock = [(10.0, 0), (11.0, 1000)]            # 1 s of the host is 1000 ns of CUPTI's
    assert c.cupti_ns(10.5) == 500
    assert c.busy_s(10.0, 10.65) == pytest.approx(350e-9)     # copies left out
    assert c.copy_s(10.0, 10.65) == pytest.approx(650e-9)


def test_collector_without_records_reads_nothing():
    c = cupti.Collector()
    c.start()
    c.stop()
    assert c.busy_s(0.0, 1.0) is None


def test_card_time_per_audio_second():
    rows = [row(100.0, 100.1, 100.5, [24000]), row(100.5, 100.6, 101.0, [12000, 12000]),
            row(101.0, 101.1, 102.0, [48000]), row(101.5, None, 102.5, None, status=-1)]
    spans = []

    def busy(t0, t1):
        spans.append((t0, t1))
        return 0.8
    run = SimpleNamespace(**vars(log(rows)), card_busy_s=busy)
    # 0.8 s of card time over the window (100 .. 102.5) for 4 s of speech
    assert spec.reader("end_to_end", "card_ms_per_audio_s")(run) == pytest.approx(200.0)
    assert spans == [(100.0, 102.5)]
    run.card_busy_s = lambda t0, t1: None
    assert spec.reader("end_to_end", "card_ms_per_audio_s")(run) is None


def test_traced_pass_rate():
    from benchmark.run import audio_rate
    rows = [row(0.0, None, 1.5, [24000]), row(0.0, None, 2.5, [48000]),
            row(0.0, None, 2.6, [48000], status=-1), row(0.0, None, 3.5, [24000])]
    assert audio_rate(rows, 1.0, 3.0, 24000) == pytest.approx(1.5)
    assert audio_rate(rows, 4.0, 5.0, 24000) is None


def tr(device, window=(0, 1000), host=(), runtime=()):
    ev = lambda xs: [trace.Event(n, s, e) for n, s, e in xs]   # noqa: E731
    return trace.TraceData(window, ev(device), ev(host), ev(runtime))


def test_union_busy_idle_and_gaps():
    t = tr([("k", 100, 300), ("k", 200, 400), ("m", 600, 700)],
           host=[("aten::conv1d", 400, 600), ("aten::add", 450, 550)])
    assert trace.union([(100, 300), (200, 400), (600, 700)]) == [(100, 400), (600, 700)]
    assert trace.busy_ns(t) == 400
    assert trace.idle_share(t) == pytest.approx(60.0)
    assert trace.gaps(t) == [(700, 1000), (400, 600), (0, 100)]
    b = trace.breakdown(t)
    assert b["device_ops"] == [["k", 4e-7], ["m", 1e-7]]
    assert b["idle_gaps"][1] == ["aten::add", 2e-7]            # the innermost op at 500
    assert b["idle_gaps"][0][0] == "(no op)"
    assert trace.idle_share(tr([])) is None


def test_breakdown_names_gaps_from_the_naming_pass():
    metrics_pass = tr([("k", 0, 900)])
    naming_pass = tr([("k", 0, 200), ("k", 700, 1000)], window=(0, 1000),
                     runtime=[("cudaStreamSynchronize", 250, 650)])
    b = trace.breakdown(metrics_pass, naming_pass)
    assert b["device_ops"] == [["k", 9e-7]]
    assert b["idle_gaps"] == [["cudaStreamSynchronize", 5e-7]]
    assert trace.breakdown(metrics_pass)["idle_gaps"] == [["(no op)", 1e-7]]


def four_stages(elem, batch=1, frames=1500):
    """(operations, bytes) of the four full-length MRF stages."""
    out, L = [], frames
    for i, (s, k) in enumerate(zip(MEDIUM["upsample_scales"], MEDIUM["upsample_kernel_sizes"])):
        out.append(flops.mrf_stage(batch, L, 512 >> i, L * s, 256 >> i, [(1, 3, 5)] * 3, 3, k, s,
                                   elem))
        L *= s
    return out


def test_stage_bounds_match_the_hand_worked_ones():
    """PERF.md's bounds of the four full-length B=1 stages: bf16 0.256 ms at
    989 TFLOP/s; f32 3.782 ms by FMA (66.9 TFLOP/s) and 1.533 ms by 3xTF32."""
    bf16 = sum(flops.bound_seconds(o, b, "bfloat16") for o, b in four_stages(2))
    f32 = sum(flops.bound_seconds(o, b, "float32") for o, b in four_stages(4))
    ops = sum(o for o, _ in four_stages(4))
    assert bf16 * 1e3 == pytest.approx(0.256, abs=5e-4)
    assert f32 * 1e3 == pytest.approx(1.533, abs=5e-4)
    assert ops / 66.9e12 * 1e3 == pytest.approx(3.782, abs=5e-3)
    # stage 0 by hand: upsample 2*7500*256*512*10/5, 18 convs of 2*7500*256*256*3
    o0, b0 = four_stages(2)[0]
    assert o0 == 2 * 7500 * 256 * 512 * 2 + 18 * 2 * 7500 * 256 * 256 * 3
    assert b0 == 2 * (1500 * 512 + 7500 * 256 + 256 * 512 * 10 + 256 + 18 * (256 * 256 * 3 + 256))


def test_request_ops():
    assert flops.vocoder_ops(MEDIUM, 1500) == pytest.approx(
        2 * 1500 * 80 * 512 * 7 + sum(o for o, _ in four_stages(4)) + 2 * 450000 * 32 * 7)
    assert flops.request_ops(MEDIUM, 0) == flops.front_ops(MEDIUM)
    assert 100e9 < flops.front_ops(MEDIUM) < 110e9


def test_roofline_and_mfu_readers():
    (o, b), = four_stages(2)[:1]
    call = (1, 1500, 512, 7500, 256, [(1, 3, 5)] * 3, 3, 10, 5, 2)
    bound = flops.bound_seconds(o, b, "bfloat16")
    ctx = SimpleNamespace(trace=tr([("void mrf_bf16_kernel<256>", 0, int(4 * bound * 1e9)),
                                    ("other", 0, 10)]),
                          mrf_calls=[call], precision="bfloat16")
    for name in ("kernel.mrf_roofline", "kernel.mrf_roofline.card"):
        ctx.mrf_calls = [call]
        assert spec.reader("metrics", name)(ctx) == pytest.approx(25.0, rel=1e-4)
        ctx.mrf_calls = []
        assert spec.reader("metrics", name)(ctx) is None
    hop = MEDIUM["hop_size"]
    recs = [row(0, 0, 1.5, [600 * hop]), row(0, 0, 2.5, [300 * hop]), row(0, 0, 5.0, [300 * hop])]
    ctx = SimpleNamespace(records=recs, window_mono=(1.0, 3.0), model=MEDIUM,
                          precision="bfloat16")
    want = 100 * (flops.request_ops(MEDIUM, 600) + flops.request_ops(MEDIUM, 300)) / (2 * 989e12)
    assert spec.reader("metrics", "mfu.serve")(ctx) == pytest.approx(want)
    # the same operations over the card's busy time (0.5 s of the 2 s pass)
    ctx.trace = tr([("k", 0, 300_000_000), ("k", 200_000_000, 500_000_000)],
                   window=(0, 2_000_000_000))
    assert spec.reader("metrics", "mfu.card")(ctx) == pytest.approx(4 * want)
    ctx.trace = tr([], window=(0, 2_000_000_000))
    assert spec.reader("metrics", "mfu.card")(ctx) is None


def test_counter_readers():
    c0 = {"batcher": {"requests": 40, "dispatches": 10}}
    c1 = {"batcher": {"requests": 100, "dispatches": 20}}
    ctx = SimpleNamespace(counters=(c0, c1))
    assert spec.reader("metrics", "batcher.mean_batch")(ctx) == 6.0
    ctx.counters = (c0, c0)
    assert spec.reader("metrics", "batcher.mean_batch")(ctx) is None
    ctx.counters = ({}, {})
    assert spec.reader("metrics", "batcher.mean_batch")(ctx) is None


def test_comparison_arithmetic():
    mix = {"endpoint": "/stream", "chunk_frames": 64}
    assert expected_samples(mix, MEDIUM, 130) == 192 * 300
    assert expected_samples(mix, MEDIUM, 0) == 64 * 300
    assert expected_samples({"endpoint": "/synthesize"}, MEDIUM, 130) == 130 * 300
    ref = np.array([1000, -1000, 1000, -1000], np.int16)
    rel, lsb = answer_errors(np.array([1000, -1000, 1000, -990], np.int16), ref)
    assert lsb == 10 and rel == pytest.approx(np.sqrt(100 / 4) / 1000)
    ok, table = verdict({"failed": 0, "length_gap": 0, "wav_max_lsb": 10, "wav_rel_rms": 9},
                        {"wav_max_lsb": 12})
    assert ok and set(table) == {"failed", "length_gap", "wav_max_lsb"}
    assert not verdict({"failed": 1, "length_gap": 0, "wav_max_lsb": 0}, {"wav_max_lsb": 12})[0]
