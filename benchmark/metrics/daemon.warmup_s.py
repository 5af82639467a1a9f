"""daemon.warmup_s (s): layer Daemon (runtime/server.py TTSServer's
warm-up); moves setup_s.  The seconds the daemon spent in its warm-up, the
program's "daemon.warmup" span (the engine's shapes, the stream's windows
and the kernel's build or load) as the recorder's per-name totals keep it
for the process: the part of set-up that is the program's own warm-up,
apart from the imports, the weights and the clients' warm-up.  Nothing to
read where the program records no such span."""

from benchmark import spans


def read(ctx):
    totals = spans.totals()
    if not totals or "daemon.warmup" not in totals:
        return None
    return totals["daemon.warmup"]["total_ns"] / 1e9
