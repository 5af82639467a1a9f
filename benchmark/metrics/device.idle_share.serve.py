"""device.idle_share.serve (%): layer Device (one H100); moves
audio_s_per_s.  The share of the traced sub-window in which no kernel, copy
or set ran on the card (the union of the profiler's device intervals)."""

from benchmark import trace


def read(ctx):
    return trace.idle_share(ctx.trace)
