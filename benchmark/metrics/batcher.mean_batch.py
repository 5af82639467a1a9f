"""batcher.mean_batch (requests): layer Batcher (runtime/batcher.py
DynamicBatcher); moves card_ms_per_audio_s: a fuller dispatch spreads the
fixed-shape front and each vocode (at the dispatch's bucket) over more
speech.  Requests packed per dispatch over the traced sub-window: the
change of the batcher's own counters (server.batcher.snapshot():
requests, dispatches) across it.  Nothing to read where the daemon runs
no batcher or dispatched nothing."""


def read(ctx):
    b0, b1 = ctx.counters[0].get("batcher"), ctx.counters[1].get("batcher")
    if b0 is None or b1 is None or b1["dispatches"] <= b0["dispatches"]:
        return None
    return (b1["requests"] - b0["requests"]) / (b1["dispatches"] - b0["dispatches"])
