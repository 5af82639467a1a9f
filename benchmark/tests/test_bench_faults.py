"""A run of each cell with the timed path broken underneath must come out
not correct, and the control (the reference in the precision below the
configuration's) must fail the cell's comparison.  Every run here is the
whole harness (daemon, clients in their own process, the check) on the
CPU at TINY_CONFIG: only the look for a card is skipped."""

import pytest
import torch

from benchmark import check, control, run
from benchmark.tests.tiny import tiny_cell

CELLS = ["medium-bf16.serve-mixed-c16", "medium-f32.batch8-long-c2"]


def altered_answer(server):
    """An answer altered where it is produced: each vocoded waveform comes
    back time-reversed."""
    eng = server.engine
    vocode = eng._vocode
    eng._vocode = lambda mel, pcm16, models=None: vocode(mel, pcm16, models).flip(-1)


def half_batch(server):
    """Half of each dispatch's rows left out: the front runs the first half
    and hands its rows to the others."""
    eng = server.engine
    front = eng._front

    def halved(src, pun, sty, nph, models=None):
        keep = max(1, src.shape[0] // 2)
        mel, mel_len = front(src[:keep], pun[:keep], sty[:keep], nph[:keep], models)
        idx = torch.arange(src.shape[0]) % keep
        return mel[idx], mel_len[idx]
    eng._front = halved


def dropped_in_bias(server):
    """One bias dropped in the fused vocoder stage: the last MRF stage's
    input bias (the upsample's bias, added in the stage) is zero in the
    program's own weights."""
    server.engine.params["vocoder"]["upsamples"][-1]["b"].zero_()


def bucket_off_by_one(server):
    """The variance adaptor's pitch lookup one bucket off: each row of the
    program's pitch embedding holds the row below it."""
    emb = server.engine.params["encoder"]["pitch_emb"]
    emb.copy_(emb.roll(1, 0))


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch,
          "dropped_in_bias": dropped_in_bias, "bucket_off_by_one": bucket_off_by_one}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run.run_cell(tiny_cell(name), 2**31 + 77, 1.5, False, device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["check"]
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("fault,name", [(f, c) for f in FAULTS for c in CELLS])
def test_broken_timed_path_is_not_correct(fault, name):
    r = run.run_cell(tiny_cell(name), 2**31 + 78, 1.5, False, device="cpu",
                     faults=FAULTS[fault])
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = tiny_cell(name)
    precision = control.LOWER[cell.config["model"]["compute_dtype"]]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        numbers = control.readings(cell, seed, precision, torch.device("cpu"))
        assert not check.verdict(numbers, cell.limits)[0], numbers
    same = control.readings(cell, 2**31 + 1, "float32", torch.device("cpu"))
    assert same["wav_max_lsb"] == 0 and check.verdict(same, cell.limits)[0]
