"""front.issue_ms (ms): layer Issuing thread / front (device.py
on_issuing_thread running runtime/engine.py's front: encoder, length
regulator, decoder); moves audio_s_per_s.  The mean duration of the
program's "issue.front" spans that end in the traced sub-window: the
issuing thread's time to launch one front, which bounds how many fronts a
second one device can start (ROADMAP perf (a)).  Nothing to read where the
program records no such span."""

from benchmark import spans


def read(ctx):
    ring = spans.ring()
    if ring is None:
        return None
    fronts = spans.ending_in(ring, ("issue.front",), ctx.trace.window)
    if not fronts:
        return None
    return sum(e.end - e.start for e in fronts) / len(fronts) / 1e6
