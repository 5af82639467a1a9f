"""daemon.self_ms (ms): layer Daemon (runtime/server.py TTSServer's handler
threads); moves audio_s_per_s.  The mean, over the /batch requests whose
"daemon.request" span ends in the traced sub-window, of the handler's own
time: the span's duration less the part of it covered by what the handler
waited on for the same request (benchmark.spans.WAITS: "issue.wait", the
issuing thread's "issue.*" runs, "engine.sync").  What is left is the
request's host work on its handler thread (reading and parsing the body,
the base64 and JSON of the answer, the socket writes, and the wait for the
interpreter lock among them).  Nothing to read where the program records no
spans or no /batch request ended in the sub-window."""

from benchmark import spans


def read(ctx):
    ring = spans.ring()
    if ring is None:
        return None
    requests = [r for r in spans.ending_in(ring, ("daemon.request",), ctx.trace.window)
                if r.a == "/batch"]
    if not requests:
        return None
    waits = [e for e in ring if e.name in spans.WAITS]
    own = [spans.self_ns(r, (w for w in waits if spans.serves(w, r.rid))) for r in requests]
    return sum(own) / len(own) / 1e6
