"""The plain reference against the program on the CPU at TINY_CONFIG: the
same weight arrays and utterances give the same mel length and the same
waveform (float32), and a bf16 program stays near it."""

import itertools
import json

import numpy as np
import pytest
import torch

from benchmark import traffic, weights
from benchmark.reference.model import Reference
from zerovox_tpu_torch.config import TINY_CONFIG

from benchmark import spec
from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_reference_matches_the_program(precision):
    from zerovox_tpu_torch.models.pipeline import cast_params, synthesize
    from zerovox_tpu_torch.params import params_from_arrays
    cell = tiny_cell("medium-f32.batch8-long-c2")
    model = dict(cell.config["model"], compute_dtype=precision)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    arrays = weights.draw(model, cell.config["assumed"], 123, torch.device("cpu"), dt)
    cfg = TINY_CONFIG.replace(compute_dtype=precision)
    params = params_from_arrays(arrays, cfg, device="cpu")
    if precision == "bfloat16":
        params = cast_params(params, torch.bfloat16)
    ref = Reference(arrays, model, "cpu")
    pool = traffic.make_pool(cell.mix, {**model, "d_model": 56}, 123)
    for u in pool[:4]:
        n = len(u.phonemes)
        src = np.zeros((1, cfg.max_n_phonemes), np.int64)
        pun = np.zeros_like(src)
        src[0, :n], pun[0, :n] = u.phonemes, u.puncts
        res = synthesize(params, cfg, src, pun, u.style[None], np.array([n]), device="cpu")
        r = ref.synthesize(*u)
        assert int(res.mel_len[0]) == r["mel_len"] == min(6 * n, cfg.max_seq_len)
        pcm = (torch.clamp(res.wav[0].float(), -1, 1) * 32767).to(torch.int16).numpy()
        diff = np.abs(pcm.astype(np.int64) - r["pcm"].astype(np.int64))
        assert diff.max() <= (1 if precision == "float32" else 2000)
    assert min(r["margins"].values()) > 0.2


def test_weights_are_the_seeds():
    cell = tiny_cell("medium-bf16.serve-mixed-c16")
    m, a = cell.config["model"], cell.config["assumed"]
    one = weights.draw(m, a, 2**31 + 5, torch.device("cpu"), torch.bfloat16)
    two = weights.draw(m, a, 2**31 + 5, torch.device("cpu"), torch.bfloat16)
    other = weights.draw(m, a, 2**31 + 6, torch.device("cpu"), torch.bfloat16)
    name = "_meldec.input_conv.w"
    assert np.array_equal(one[name], two[name]) and not np.array_equal(one[name], other[name])
    # rounded to the served dtype: bf16 values in float32 arrays
    assert np.array_equal(one[name], torch.from_numpy(one[name]).bfloat16().float().numpy())


def test_traffic_is_the_same_work_for_every_seed():
    mix = json.loads((spec.HERE / "traffic" / "serve-mixed-c16.json").read_text())
    m = {"num_phonemes": 154, "num_puncts": 6, "d_model": 528}
    a, b = traffic.make_pool(mix, m, 1), traffic.make_pool(mix, m, 2**40 + 3)
    assert sorted(len(u.phonemes) for u in a) == sorted(len(u.phonemes) for u in b)
    assert not np.array_equal(a[0].style, b[0].style)
    orders = list(itertools.islice(traffic.client_requests(mix, 7, 0), 64))
    assert sorted(i for o in orders for i in o) == list(range(64))
