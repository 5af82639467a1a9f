"""mfu.card (%): layer Whole step; moves card_ms_per_audio_s.  The model's
operations for the requests answered in the traced sub-window (their
utterances' front at its fixed shape and vocoder at their own mel length,
benchmark.flops.request_ops) over the card's busy time in the sub-window
(the union of the profiler's device intervals) times the chip's peak in the
configuration's precision: the whole step's share of the peak while the
card works, so that card time per second of speech falls as it rises."""

from benchmark import flops, trace


def read(ctx):
    done = [r for r in ctx.records
            if r["status"] == 200 and ctx.window_mono[0] <= r["t_done"] < ctx.window_mono[1]]
    busy = trace.busy_ns(ctx.trace) / 1e9
    if not done or busy <= 0:
        return None
    ops = sum(flops.request_ops(ctx.model, n // ctx.model["hop_size"])
              for r in done for n in r["samples"])
    return 100.0 * ops / (busy * flops.PEAK_FLOPS[ctx.precision])
