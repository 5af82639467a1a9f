"""card_ms_per_audio_s (ms/audio-s): the card's busy time per second of
speech answered: the milliseconds in which a kernel or a set ran on the
card (CUPTI's records of the whole window, benchmark.cupti; copies, paced
by the host where they land in pageable memory, are left out) from the
window's start to the last answer, over the seconds of speech (PCM16
samples returned / sampling rate) answered by every request sent in the
window.  What each second of speech costs the card, however fast the host
feeds it."""


def read(run):
    ok = [r for r in run.records if r["status"] == 200]
    if not ok:
        return None
    audio_s = sum(sum(r["samples"]) for r in ok) / run.sampling_rate
    busy = run.card_busy_s(run.t_go, max(r["t_done"] for r in run.records))
    if busy is None or audio_s <= 0:
        return None
    return 1e3 * busy / audio_s
