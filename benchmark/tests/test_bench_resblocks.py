"""Resblocks whose kernel sizes differ (HiFi-GAN V1's 3/7/11): the weight
table, the plain reference's vocoder and the operation counts all read each
resblock's size from `reference.geometry.resblock_kernel_sizes`.  The medium
configurations, which give one size, keep the table and the counts pinned
below; a list of equal sizes changes nothing; a 3/7/11 vocoder agrees with
HiFi-GAN's equations written out here."""

import hashlib
import json
import math

import pytest
import torch
import torch.nn.functional as F

from benchmark import flops, spec, weights
from benchmark.reference.geometry import resblock_kernel_sizes
from benchmark.reference.model import Reference
from zerovox_tpu_torch.config import TINY_CONFIG

CONFIGS = ["zerovox-medium-bf16", "zerovox-medium-f32"]
ASSUMED = json.loads((spec.HERE / "configs" / "zerovox-medium-f32.json").read_text())["assumed"]

# Taken from the harness before it read per-resblock sizes: the weight
# table's length, its element count and the sha256 of its JSON
# ([name, shape, init] per leaf); vocoder_ops at 120, 720 and 1500 frames;
# (operations, bytes) of the four B=1 stages at 1500 frames, bf16 then f32.
TABLE = (323, 76911140, "b4c276be7503bc8db8a310ce171b13bf7d13249c438000e3bf44336ff91c9ac5")
VOCODER_OPS = {120: 20325734400.0, 720: 121954406400.0, 1500: 254071680000.0}
STAGES = [(57016320000.0, 15085056), (57016320000.0, 30170112),
          (71270400000.0, 15869696), (71270400000.0, 31739392),
          (71270400000.0, 29375872), (71270400000.0, 58751744),
          (53452800000.0, 48136384), (53452800000.0, 96272768)]


def model_of(name: str) -> dict:
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["model"]


def table(m: dict):
    specs = weights.leaves(m, ASSUMED)
    blob = json.dumps([[n, list(shape), list(init)] for n, shape, init in specs])
    return (len(specs), sum(math.prod(shape) for _, shape, _ in specs),
            hashlib.sha256(blob.encode()).hexdigest())


def stages(m: dict, sizes, frames=1500, with_upsample=True):
    """(operations, bytes) of each full-length B=1 stage, bf16 then f32."""
    out, L = [], frames
    for i, (s, k) in enumerate(zip(m["upsample_scales"], m["upsample_kernel_sizes"])):
        c = m["hifigan_channels"]
        for elem in (2, 4):
            out.append(flops.mrf_stage(1, L, c >> i, L * s, c >> (i + 1), m["resblock_dilations"],
                                       sizes, k if with_upsample else None,
                                       s if with_upsample else None, elem))
        L *= s
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_medium_tables_and_counts_are_the_pinned_ones(name):
    m = model_of(name)
    assert resblock_kernel_sizes(m) == [3, 3, 3]
    assert table(m) == TABLE
    assert {n: flops.vocoder_ops(m, n) for n in VOCODER_OPS} == VOCODER_OPS
    assert stages(m, m["resblock_kernel_size"]) == STAGES


@pytest.mark.parametrize("name", CONFIGS)
def test_a_list_of_equal_sizes_changes_nothing(name):
    m = model_of(name)
    listed = dict(m, resblock_kernel_sizes=[3, 3, 3])
    assert weights.leaves(listed, ASSUMED) == weights.leaves(m, ASSUMED)
    assert {n: flops.vocoder_ops(listed, n) for n in VOCODER_OPS} == VOCODER_OPS
    assert stages(m, [3, 3, 3]) == STAGES


def tiny(**over) -> dict:
    m = json.loads(TINY_CONFIG.to_json())
    m.update(over)
    return m


def test_a_list_of_equal_sizes_vocodes_the_same_waveform():
    m = tiny()
    arrays = weights.draw(m, ASSUMED, 2**31 + 11, torch.device("cpu"), torch.float32)
    mel = torch.randn(m["num_mels"], 12, generator=torch.Generator().manual_seed(3))
    one = Reference(arrays, m, "cpu").vocode(mel)
    listed = dict(m, resblock_kernel_sizes=[m["resblock_kernel_size"]] * m["num_resblocks"])
    assert weights.leaves(listed, ASSUMED) == weights.leaves(m, ASSUMED)
    assert torch.equal(Reference(arrays, listed, "cpu").vocode(mel), one)


V1_SIZES = [3, 7, 11]


def tiny_v1() -> dict:
    """TINY's widths with HiFi-GAN V1's resblocks (kernels 3, 7, 11, each
    with dilations 1, 3, 5) and even upsample scales with kernels twice the
    scale, as V1's are (the single size stays, as the port's files carry
    it; the list wins)."""
    return tiny(num_resblocks=3, resblock_dilations=[[1, 3, 5]] * 3,
                resblock_kernel_sizes=V1_SIZES, upsample_scales=[4, 2, 2],
                upsample_kernel_sizes=[8, 4, 4], hop_size=16)


def get_padding(kernel_size, dilation=1):
    return int((kernel_size * dilation - dilation) / 2)


def hifigan_generator(w: dict, m: dict, mel: torch.Tensor) -> torch.Tensor:
    """HiFi-GAN's generator (Kong et al. 2020, section 2.1; ResBlock1 and the
    MRF of jik876/hifi-gan): every resblock computes, per dilation,
    x = x + c2(lrelu(c1(lrelu(x)))); the MRF is the mean of its resblocks.
    On the export's arrays: normalised mel, transposed-conv kernels stored
    flipped as (out, in, K)."""
    x = ((mel - w["hifigan.mean"][:, None]) / w["hifigan.scale"][:, None])[None]
    k = m["hifigan_kernel_size"]
    x = F.conv1d(x, w["_meldec.input_conv.w"], w["_meldec.input_conv.b"], padding=get_padding(k))
    for i, (u, uk) in enumerate(zip(m["upsample_scales"], m["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, 0.1)
        up = w[f"_meldec.upsamples.{i}.1.w"].flip(-1).transpose(0, 1)
        x = F.conv_transpose1d(x, up, w[f"_meldec.upsamples.{i}.1.b"], stride=u,
                               padding=(uk - u) // 2)
        xs = None
        for j, ks in enumerate(V1_SIZES):
            h = x
            for n, d in enumerate(m["resblock_dilations"][j]):
                c1 = f"_meldec.blocks.{i * len(V1_SIZES) + j}.convs1.{n}.1"
                c2 = f"_meldec.blocks.{i * len(V1_SIZES) + j}.convs2.{n}.1"
                assert w[c1 + ".w"].shape[-1] == w[c2 + ".w"].shape[-1] == ks
                xt = F.conv1d(F.leaky_relu(h, 0.1), w[c1 + ".w"], w[c1 + ".b"], dilation=d,
                              padding=get_padding(ks, d))
                xt = F.conv1d(F.leaky_relu(xt, 0.1), w[c2 + ".w"], w[c2 + ".b"],
                              padding=get_padding(ks))
                h = xt + h
            xs = h if xs is None else xs + h
        x = xs / len(V1_SIZES)
    x = F.leaky_relu(x)
    x = F.conv1d(x, w["_meldec.output_conv.1.w"], w["_meldec.output_conv.1.b"],
                 padding=get_padding(k))
    return torch.tanh(x)[0, 0]


def test_reference_vocodes_resblocks_of_3_7_11_as_hifigan_does():
    m = tiny_v1()
    arrays = weights.draw(m, ASSUMED, 2**33 + 7, torch.device("cpu"), torch.float32)
    ref = Reference(arrays, m, "cpu")
    ref.w = {k: v.double() for k, v in ref.w.items()}       # both sides in float64
    mel = torch.randn(m["num_mels"], 20, generator=torch.Generator().manual_seed(5),
                      dtype=torch.float64)
    got = ref.vocode(mel)
    want = hifigan_generator(ref.w, m, mel)
    assert got.shape == want.shape == (20 * m["hop_size"],)
    assert torch.max(torch.abs(got - want)).item() < 1e-10
    assert torch.std(want).item() > 1e-2                     # not a flat signal
    # the single size alone would draw and vocode every resblock at 3
    three = {k: v for k, v in m.items() if k != "resblock_kernel_sizes"}
    assert weights.leaves(three, ASSUMED) != weights.leaves(m, ASSUMED)


def test_counts_of_resblocks_3_7_11():
    m = dict(model_of("zerovox-medium-bf16"), resblock_kernel_sizes=V1_SIZES)
    v1 = [o for o, _ in stages(m, V1_SIZES, with_upsample=False)]
    same = [o for o, _ in stages(m, [3, 3, 3], with_upsample=False)]
    assert all(a * 9 == b * 21 for a, b in zip(v1, same))
    # through vocoder_ops, which reads the configuration's list
    rest = (flops.vocoder_ops(m, 1500) - VOCODER_OPS[1500]) * 9
    assert rest == sum(same[::2]) * 12
    # the weight bytes counted are the weights drawn: each stage's upsample
    # and its three resblocks, at one byte an element
    L = 1500
    for i, (s, uk) in enumerate(zip(m["upsample_scales"], m["upsample_kernel_sizes"])):
        c_in, c = 512 >> i, 256 >> i
        nb = flops.mrf_stage(1, L, c_in, L * s, c, m["resblock_dilations"], V1_SIZES, uk, s, 1)[1]
        drawn = sum(math.prod(shape) for n, shape, _ in weights.leaves(m, ASSUMED)
                    if n.startswith(f"_meldec.upsamples.{i}.")
                    or any(n.startswith(f"_meldec.blocks.{3 * i + j}.") for j in range(3)))
        assert nb - (L * c_in + L * s * c) == drawn
        L *= s


@pytest.mark.parametrize("sizes, why", [([3, 7], "entries"), ([3, 7, 11, 3], "entries"),
                                        ([3, 6, 11], "odd")])
def test_sizes_that_do_not_fit_are_refused(sizes, why):
    m = dict(model_of("zerovox-medium-bf16"), resblock_kernel_sizes=sizes)
    for use in (resblock_kernel_sizes, lambda m: weights.leaves(m, ASSUMED),
                lambda m: flops.vocoder_ops(m, 120)):
        with pytest.raises(ValueError, match=why):
            use(m)
    with pytest.raises(ValueError):
        flops.mrf_stage(1, 10, 8, 20, 4, [(1, 3, 5)] * 3, [3, 7], None, None, 2)


def test_recorder_keeps_each_resblocks_size(monkeypatch):
    from zerovox_tpu_torch.models import hifigan

    from benchmark.run import Recorder
    monkeypatch.setattr(hifigan, "mrf_stage", lambda x, blocks, dils, ks, **kw: x)
    rec = Recorder()
    try:
        rec.on = True
        x = torch.zeros(2, 4, 10)
        hifigan.mrf_stage(x, [None] * 3, [[1, 3, 5]] * 3, V1_SIZES)
        hifigan.mrf_stage(x, [None] * 3, [[1, 3, 5]] * 3, 3)
    finally:
        rec.remove()
    assert [c[6] for c in rec.calls] == [(3, 7, 11), 3]
    ops = [flops.mrf_stage(*c)[0] for c in rec.calls]
    assert ops[0] * 9 == ops[1] * 21
    assert ops[1] == 2 * 9 * 2.0 * (2 * 4) * 10 * 10 * 3       # 18 convs on B x L = 2 x 4 rows
