"""mfu.serve (%): layer Whole step; moves audio_s_per_s.  The model's
operations for the requests answered in the traced sub-window (their
utterances' front at its fixed shape and vocoder at their own mel length,
benchmark.flops.request_ops; the answer's length gives the mel length) over
the sub-window's seconds times the chip's peak in the configuration's
precision (989 TFLOP/s bfloat16, 165 TFLOP/s float32 as 3xTF32)."""

from benchmark import flops


def read(ctx):
    done = [r for r in ctx.records
            if r["status"] == 200 and ctx.window_mono[0] <= r["t_done"] < ctx.window_mono[1]]
    if not done:
        return None
    ops = sum(flops.request_ops(ctx.model, n // ctx.model["hop_size"])
              for r in done for n in r["samples"])
    span = ctx.window_mono[1] - ctx.window_mono[0]
    return 100.0 * ops / (span * flops.PEAK_FLOPS[ctx.precision])
