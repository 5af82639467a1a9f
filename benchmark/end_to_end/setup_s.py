"""setup_s (s): process start to the first request of the window: imports,
the weights made on the card, the daemon built and warmed up, the clients
started and their warm-up requests answered (host clock)."""


def read(run):
    return run.setup_s
