"""vocoder.fill (%): layer Vocoder (models/hifigan.py vocode, through the
engine's calls); moves audio_s_per_s.  The frames the vocoder calls of the
traced sub-window needed (the mel lengths of their real rows) over the
frames they vocoded (every row, ladder padding included, at the call's
bucket): the sums of the two values of the program's "vocoder.frames"
counters stamped in the sub-window (benchmark.spans).  Nothing to read where
the program records no such counter."""

from benchmark import spans


def read(ctx):
    ring = spans.ring()
    if ring is None:
        return None
    lo, hi = ctx.trace.window
    frames = [e for e in ring if e.name == "vocoder.frames" and lo <= e.start < hi]
    vocoded = sum(e.b for e in frames)
    if vocoded <= 0:
        return None
    return 100.0 * sum(e.a for e in frames) / vocoded
