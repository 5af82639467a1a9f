"""device.idle_issuing (%): layer Device (one H100); moves audio_s_per_s.
The share of the traced sub-window in which no kernel, copy or set ran on
the card (the profiler's device intervals) while the issuing thread was
launching (inside one of the program's "issue.front", "issue.vocode" or
"issue.stream" spans): the card waiting on the host's launches.  Nothing to
read where the program records no such span in the sub-window or the trace
holds no device event."""

from benchmark import spans


def read(ctx):
    ring = spans.ring()
    if ring is None or not ctx.trace.device:
        return None
    lo, hi = ctx.trace.window
    issuing = [(max(e.start, lo), min(e.end, hi)) for e in ring
               if e.name in spans.ISSUED and e.end > lo and e.start < hi]
    if not issuing:
        return None
    busy = [(d.start, d.end) for d in ctx.trace.device]
    return 100.0 * spans.minus_ns(issuing, busy) / (hi - lo)
