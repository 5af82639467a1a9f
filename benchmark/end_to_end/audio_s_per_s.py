"""audio_s_per_s (audio-s/s): seconds of speech answered (PCM16 samples
returned / sampling rate) by every request sent in the window, over the
time from the window's start to the last of those answers (host clock, at
the clients)."""


def read(run):
    ok = [r for r in run.records if r["status"] == 200]
    if not ok:
        return None
    samples = sum(sum(r["samples"]) for r in ok)
    span = max(r["t_done"] for r in run.records) - run.t_go
    return samples / run.sampling_rate / span
