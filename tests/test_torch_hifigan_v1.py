"""HiFi-GAN V1's vocoder on the port's normal path, on the CPU.

V1 is the generator of jik876/hifi-gan's config_v1.json: resblock kernels
3/7/11, each with dilations (1, 3, 5), upsample 8-8-2-2 with kernels
16-16-4-4, 22.05 kHz, hop 256 (benchmark/configs/zerovox-hifiganv1-bf16.json
puts it behind zerovox medium's front).  Held here:

  * the config's per-resblock sizes, their checks and serialisation, with
    zerovox's configs, JSON and GGUF keys as the JAX package writes them;
  * the receptive field (15 frames for V1, 9 for medium) and a mel cut past
    it changing no earlier sample;
  * the MRF kernel's geometry and routes at V1's widths: a 60-row halo,
    every stage in the bf16 kernel, each resblock a launch of its own at
    its own halo and tile (the k = 11 one at 256 channels in one launch
    per dilation slot), what _launch passes each launch, no stage of mixed
    sizes in float32 or under f16_staging, and medium's plans and its one
    launch a stage as they were;
  * the ragged pack of the bf16 weights, launch by launch;
  * the vocoder, a stream and the whole synthesis at a small V1-shaped
    geometry (TINY's front, V1's vocoder at 64 channels) against the
    benchmark's plain reference (benchmark/reference/model.py on
    benchmark/weights.py arrays, plain torch, none of the port).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zerovox_tpu.config import ZeroVoxConfig as JaxConfig

from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
from zerovox_tpu_torch.models import hifigan
from zerovox_tpu_torch.models.pipeline import cast_params, synthesize
from zerovox_tpu_torch.models.streaming import StreamingSynthesizer
from zerovox_tpu_torch.ops.conv import f16_staging
from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
from zerovox_tpu_torch.params import init_params, load_params, params_from_arrays, save_params

from benchmark import traffic, weights
from benchmark.reference.model import Reference

V1_FILE = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "zerovox-hifiganv1-bf16.json"
V1_JSON = json.loads(V1_FILE.read_text())
V1 = ZeroVoxConfig.from_json(json.dumps(V1_JSON["model"]))
MEDIUM = ZeroVoxConfig()
V1_VOCODER = dict(hop_size=256, sampling_rate=22050, upsample_scales=(8, 8, 2, 2),
                  upsample_kernel_sizes=(16, 16, 4, 4), num_resblocks=3,
                  resblock_dilations=((1, 3, 5),) * 3, resblock_kernel_sizes=(3, 7, 11))
# TINY's front and V1's vocoder at 64 channels (stages of 32, 16, 8 and 4)
SMALL = TINY_CONFIG.replace(hifigan_channels=64, **V1_VOCODER)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# each stage's (channels, upsample input channels, stride, upsample kernel)
V1_STAGES = [(256, 512, 8, 16), (128, 256, 8, 16), (64, 128, 2, 4), (32, 64, 2, 4)]
MEDIUM_STAGES = [(256, 512, 5, 10), (128, 256, 5, 10), (64, 128, 4, 8), (32, 64, 3, 6)]


# ------------------------------------------------------------------ the config

def test_config_per_resblock_sizes():
    """resblock_kernels gives each resblock's size: V1's file 3/7/11,
    zerovox's one size for every resblock; one odd size a resblock or the
    config is refused; V1's JSON round-trips with its sizes."""
    assert V1.resblock_kernels == (3, 7, 11) and V1.resblock_kernel_size == 3
    assert (V1.hop_size, V1.sampling_rate, V1.upsample_scales) == (256, 22050, (8, 8, 2, 2))
    assert MEDIUM.resblock_kernels == (3, 3, 3) and TINY_CONFIG.resblock_kernels == (3, 3)
    assert MEDIUM.replace(resblock_kernel_size=5).resblock_kernels == (5, 5, 5)
    for bad in ((3, 7), (3, 8, 11), (3, 7, 11, 13), (3, -1, 11)):
        with pytest.raises(ValueError, match="one odd size per resblock"):
            MEDIUM.replace(resblock_kernel_sizes=bad)
    assert ZeroVoxConfig.from_json(V1.to_json()) == V1
    assert json.loads(V1.to_json())["resblock_kernel_sizes"] == [3, 7, 11]


@pytest.mark.parametrize("cfg,jcfg", [(MEDIUM, JaxConfig()),
                                      (TINY_CONFIG, None)], ids=["medium", "tiny"])
def test_zerovox_configs_serialise_as_the_jax_package(cfg, jcfg):
    """An empty resblock_kernel_sizes is left out of the JSON, so zerovox's
    configs, their GGUF config key and their GGUF hparams are the JAX
    package's byte for byte, and each package reads the other's JSON back
    exactly."""
    if jcfg is None:
        from zerovox_tpu.config import TINY_CONFIG as jcfg
    assert "resblock_kernel_sizes" not in cfg.to_json()
    assert cfg.to_json() == jcfg.to_json()
    assert cfg.to_gguf_kv() == jcfg.to_gguf_kv()
    assert ZeroVoxConfig.from_json(jcfg.to_json()) == cfg
    assert JaxConfig.from_json(cfg.to_json()) == jcfg


def test_v1_gguf_round_trip(tmp_path):
    """A V1-shaped checkpoint: save_params writes the sizes in the config
    key, load_params reads them back, and each resblock's convs load at
    its own size (C, C, K_j)."""
    params = init_params(SMALL, seed=4, device="cpu")
    path = str(tmp_path / "v1.gguf")
    save_params(path, params, SMALL)
    cfg, loaded = load_params(path, device="cpu", use_native=False)
    assert cfg == SMALL and cfg.resblock_kernels == (3, 7, 11)
    blocks = loaded["vocoder"]["blocks"]
    for i, (_, c) in enumerate([(32, 32), (16, 16), (8, 8), (4, 4)]):
        for j, k in enumerate((3, 7, 11)):
            for cs in ("convs1", "convs2"):
                w = blocks[3 * i + j][cs][2]["w"]
                assert tuple(w.shape) == (c, c, k)
                # stored f16, as the reference exporter stores conv kernels
                torch.testing.assert_close(
                    w, params["vocoder"]["blocks"][3 * i + j][cs][2]["w"].half().float(),
                    rtol=0, atol=0)


# ------------------------------------------------------- the receptive field

def test_receptive_field_frames():
    """The right halo, each resblock at its own size: 3 + sum over stages
    (h * s + k_up + 60) = 3699 samples at V1 (15 frames of 256), 9 frames of
    300 at medium."""
    assert hifigan.receptive_field_frames(V1) == 15
    assert hifigan.receptive_field_frames(SMALL) == 15
    assert hifigan.receptive_field_frames(MEDIUM) == 9


def test_mel_cut_past_the_field_changes_no_earlier_sample():
    """Vocoding mel[:, :n + 15] gives the first n * 256 samples of the whole
    mel's run (atol 1e-6: the same f32 sums at another length, up to the
    convs' blocking; the readings are 3e-8 to 9e-8); a cut 3 frames past n
    moves them by more than 1e-3, so the check can see a short field."""
    params = init_params(SMALL, seed=5, device="cpu")
    mel = torch.randn(1, SMALL.max_seq_len, SMALL.num_mels,
                      generator=torch.Generator().manual_seed(5))
    n, hop = 30, SMALL.hop_size
    with torch.no_grad():
        full = hifigan.vocode(params, SMALL, mel)[0, :n * hop]
        cut = hifigan.vocode(params, SMALL, mel[:, :n + 15])[0, :n * hop]
        short = hifigan.vocode(params, SMALL, mel[:, :n + 3])[0, :n * hop]
    torch.testing.assert_close(cut, full, rtol=0, atol=1e-6)
    assert (short - full).abs().max() > 1e-3


# ------------------------------------------------------ the kernel's geometry

def test_stage_halo():
    """12 rows a side at k=3 with dilations (1, 3, 5); at 3/7/11 the k=11
    resblock's 5 * (2 + 4 + 6) = 60."""
    assert ms.stage_halo(MEDIUM.resblock_dilations, 3) == 12
    assert ms.stage_halo(V1.resblock_dilations, V1.resblock_kernels) == 60
    assert ms.stage_halo(V1.resblock_dilations, (11, 3, 3)) == 60
    with pytest.raises(ValueError, match="2 resblock kernel sizes for 3"):
        ms.stage_halo(V1.resblock_dilations, (3, 7))


@pytest.mark.parametrize("kr", [3, (3, 3, 3)], ids=["int", "per-resblock"])
def test_medium_plans_pinned(kr):
    """zerovox medium's stages compile to the plans they had, whether its
    size comes as one int or per resblock: bf16 tiles 68 / 168 / 488 / 488
    in windows 92 / 192 / 512 / 512, f32 tiles 64 / 170 / 358 / 740."""
    dils = MEDIUM.resblock_dilations
    bf16 = [ms.bf16_plan(C, dils, kr, cin, k, s) for C, cin, s, k in MEDIUM_STAGES]
    f32 = [ms.tile_plan(C, dils, kr, cin, k, s) for C, cin, s, k in MEDIUM_STAGES]
    assert [p.tile for p in bf16] == [68, 168, 488, 488]
    assert [p.window for p in bf16] == [92, 192, 512, 512]
    assert [p.margin for p in bf16] == [5] * 4
    assert [p.tile for p in f32] == [64, 170, 358, 740]
    assert bf16 == [ms.bf16_plan(C, dils, 3, cin, k, s) for C, cin, s, k in MEDIUM_STAGES]


def test_v1_bf16_plans():
    """V1 in bf16 runs each resblock as a stage of its own (stage_launches),
    at its own halo: at C = 128 tiles of 168 / 120 / 72 rows in windows of
    192 (halos 12 / 36 / 60), at C = 64 and 32 tiles of 488 / 440 / 392 in
    windows of 512, the operand margin each resblock's largest tap shift
    (5, 15, 25 rows).  At C = 256 (stage 1) k = 3 and k = 7 run one launch
    each (tiles of 68 and 56 in windows of 92 and 128), and k = 11, whose
    60-row halo no window of the design holds, one launch per dilation
    slot at halos 10 / 20 / 30: tiles of 72 / 88 / 60 in windows of 92 /
    128 / 120 (chunks of 64, 16 and 16: with 64 the last two would leave
    tiles of 42 and 12).  The three resblocks in one cluster would have
    tiles of 72 / 392 / 392 at C = 128 / 64 / 32, and at C = 256 three
    slot launches of all three."""
    dils, kr = V1.resblock_dilations, V1.resblock_kernels

    def plans(C, cin, s, k):
        route = ms.stage_launches(C, dils, kr, (cin, k, s))
        return [(p.tile, p.window, p.kb, p.margin) for p in (
            ms.bf16_plan(C, *ms.launch_dilations(dils, kr, ln),
                         *((cin, k, s) if ln.reads_x else ())) for ln in route.launches)]

    assert plans(*V1_STAGES[0]) == [(68, 92, 64, 5), (56, 128, 16, 15), (72, 92, 64, 5),
                                    (88, 128, 16, 15), (60, 120, 16, 25)]
    assert plans(*V1_STAGES[1]) == [(168, 192, 128, 5), (120, 192, 128, 15), (72, 192, 128, 25)]
    for stage in V1_STAGES[2:]:
        C = stage[0]
        assert plans(*stage) == [(488, 512, C, 5), (440, 512, C, 15), (392, 512, C, 25)]
    with pytest.raises(ValueError, match="halo 60 leaves no room"):
        ms.bf16_plan(256, dils, kr, 512, 16, 8)
    assert ms.stage_segments(256, dils, kr) == ((0, 1), (1, 2), (2, 3))
    assert ms.bf16_plan(256, ((3,),) * 3, kr, kb=64).tile == 42
    assert ms.bf16_plan(256, ((5,),) * 3, kr, kb=64).tile == 12
    for C, _, _, _ in V1_STAGES[1:]:
        assert ms.stage_segments(C, dils, kr) == ((0, 3),)
    for C, _, _, _ in MEDIUM_STAGES:
        assert ms.stage_segments(C, MEDIUM.resblock_dilations, 3) == ((0, 3),)
    together = [ms.bf16_plan(C, dils, kr, cin, k, s) for C, cin, s, k in V1_STAGES[1:]]
    assert [(p.tile, p.window, p.margin) for p in together] == [(72, 192, 25), (392, 512, 25),
                                                                (392, 512, 25)]
    with pytest.raises(ValueError, match="only the bf16 mode"):
        ms.tile_plan(128, dils, kr, 256, 16, 8)


def test_resblocks_launch_alone_exactly_where_sizes_differ():
    """stage_launches runs a stage's resblocks one at a time exactly where
    their kernel sizes differ (in the bf16 mode, the only one that takes
    such a stage): V1's 3/7/11 and 11/3/7 at every V1 width, in resblock
    order, the first launch reading x and handing the stage input on, the
    last (the last resblock's) writing y after the two final states.
    zerovox medium (one int or per resblock), (3, 3, 3) at V1's widths and
    a lone k = 11 resblock keep one cluster of every resblock a launch (at
    C = 256 k = 11 everywhere: three launches by dilation slot), as do the
    f16-staged and float32 modes; medium's plans are test_medium_plans_pinned's."""
    dils = V1.resblock_dilations
    for C, cin, s, k in V1_STAGES:
        for ks in ((3, 7, 11), (11, 3, 7)):
            route = ms.stage_launches(C, dils, ks, (cin, k, s))
            blocks = [ln.blocks for ln in route.launches]
            assert set(blocks) == {(0,), (1,), (2,)} and blocks == sorted(blocks)
            first, last = route.launches[0], route.launches[-1]
            assert first.reads_x and first.x_out >= 0 and not any(
                ln.reads_x for ln in route.launches[1:])
            assert last.h_out == -1 and last.n_sum == 2
            assert sum(ln.h_out == -1 for ln in route.launches) == 1
    one = ms.StageLaunch((0, 1, 2), (0, 3), True, -1, -1, 0, -1)
    for C, cin, s, k in V1_STAGES[1:] + MEDIUM_STAGES:
        for ks in (3, (3, 3, 3)):
            assert ms.stage_launches(C, dils, ks, (cin, k, s)) == ms.StageRoute((one,), 0)
        for mode in ("f16_staged", "f32"):
            assert ms.stage_launches(C, dils, (3, 3, 3), (cin, k, s), mode) == \
                ms.StageRoute((one,), 0)
    assert ms.stage_launches(128, dils[:1], 11, (256, 16, 8)).launches == (
        one._replace(blocks=(0,)),)
    split = ms.stage_launches(256, dils, 11, (512, 16, 8))
    assert [(ln.blocks, ln.slots) for ln in split.launches] == [
        ((0, 1, 2), (0, 1)), ((0, 1, 2), (1, 2)), ((0, 1, 2), (2, 3))]
    assert split.slots == 6


@pytest.mark.parametrize("B,frames,alone", [
    (1, 1500, [True] * 4), (8, 1024, [True] * 4), (2, 256, [True] * 4),
    (1, 256, [False, True, True, True]), (1, 96, [False, True, False, False]),
    (1, 44, [False] * 4)])
def test_resblocks_run_together_in_one_wave(B, frames, alone):
    """With a grid, V1's resblocks run alone only where their tiles, all
    three at once, take an H100's clusters more than one wave (44 clusters
    of three, 88 at C=32 where two CTAs share an SM): a long stage or a
    batch alone; a stream window's stage 1, 3 and 4 (B = 1, 96 frames) and
    every stage of a 44-frame tail together, in one wave, where three
    launches in turn would each take a wave's time."""
    L, got = frames, []
    for C, cin, s, k in V1_STAGES:
        L *= s
        route = ms.stage_launches(C, V1.resblock_dilations, (3, 7, 11), (cin, k, s), B=B,
                                  L_out=L, wave=88 if C == 32 else 44)
        got.append(route.launches[0].blocks == (0,))
        assert route == ms.stage_launches(C, V1.resblock_dilations, (3, 7, 11), (cin, k, s)) if \
            got[-1] else all(ln.blocks == (0, 1, 2) for ln in route.launches)
    assert got == alone


@pytest.mark.parametrize("case", ["v1-long", "v1-one-wave", "medium"])
def test_launch_passes_the_route(monkeypatch, case):
    """_launch on V1's stage 2 geometry (C = 128; meta tensors, the library
    and the card stubbed), B = 2 x 80 rows.  V1 (3/7/11) where its tiles
    take the clusters more than one wave (a card of one cluster a wave):
    one entry call per resblock in order, each at its own halo and plan,
    its convs found in the chain-order pack by their place (conv0, tap0);
    the first reads x (the upsample, in_bias, in_leaky) and writes the
    stage input to scratch slot 2, the next two read it there, the k = 7
    launch leaves its final state in slot 1 (k = 3's in slot 0), and the
    k = 11 launch sums slots 0-1 before its own into y under out_leaky;
    counted in launches and resblock_launches.  V1 in one wave (44 clusters
    a wave) and zerovox medium: one call of all three resblocks, not
    counted in resblock_launches."""
    import contextlib
    from types import SimpleNamespace
    calls = []
    lib = SimpleNamespace(stage={"bf16": lambda *a: calls.append(a) or 0},
                          error_string=lambda e: b"")
    wave3 = 1 if case == "v1-long" else 44                # clusters of three a wave
    monkeypatch.setattr(ms, "library", lambda: lib)
    monkeypatch.setattr(ms, "wave_clusters",
                        lambda dev, n_rb, C, mode, mt: 132 if n_rb == 1 else wave3)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: SimpleNamespace(cuda_stream=0))
    ms._wgmma_launches.cache_clear()
    monkeypatch.setattr(ms.mrf_stage, "launches", 0)
    monkeypatch.setattr(ms.mrf_stage, "resblock_launches", 0)

    def meta(*shape):
        return torch.empty(*shape, device="meta", dtype=torch.bfloat16)

    C, cin, s, k = V1_STAGES[1]
    B, L_pre, L_out = 2, 10, 80
    dils, kr = ((MEDIUM.resblock_dilations, 3) if case == "medium"
                else (V1.resblock_dilations, (3, 7, 11)))
    ks = ms.resblock_sizes(kr, 3)
    blocks = [{cs: [{"w": meta(C, C, kj), "b": meta(C)} for _ in ds]
               for cs in ("convs1", "convs2")} for ds, kj in zip(dils, ks)]
    up = dict(w=meta(C, cin, k), stride=s, padding=s // 2, output_padding=0)
    with torch.no_grad():
        y = ms.mrf_stage(meta(B, L_pre, cin), blocks, dils, kr, upsample=up,
                         in_bias=meta(C), in_leaky=0.1, out_leaky=0.1)
    ms._wgmma_launches.cache_clear()
    assert y.shape == (B, L_out, C)
    route = ms.stage_launches(C, dils, ks, (cin, k, s), B=B, L_out=L_out, wave=wave3)
    alone = case == "v1-long"
    assert len(calls) == len(route.launches) == (3 if alone else 1)
    assert route.launches[0].blocks == ((0,) if alone else (0, 1, 2))
    sb = B * L_out * C * 4                      # bytes of a scratch slot (from address 0)
    for a, ln in zip(calls, route.launches):
        sd, kl = ms.launch_dilations(dils, ks, ln)
        plan = ms.bf16_plan(C, sd, kl, *((cin, k, s) if ln.reads_x else ()), B=B,
                            L_out=L_out, wave=132 if alone else wave3)
        first, last = ln.reads_x, ln.h_out < 0
        assert [v is not None for v in a[:3]] == [first] * 3          # x, w_up, in_bias
        assert a[3:5] == (0, 0)                                       # the whole pack
        assert a[6:11] == (None if ln.h_in < 0 else ln.h_in * sb,
                           None if last else ln.h_out * sb, 0 if ln.n_sum else None,
                           ln.n_sum, None if ln.x_out < 0 else ln.x_out * sb)
        assert a[11:17] == ((B, L_pre, cin, C, L_out, k) if first else (B, L_out, C, C,
                                                                        L_out, 0))
        assert (a[19], a[21]) == (int(first), int(last))
        assert a[23] == len(ln.blocks) and list(a[25]) == list(kl)
        # chain order: 6 convs a resblock, each of its own size
        assert list(a[27]) == [6 * j for j in ln.blocks]
        assert list(a[28]) == [6 * sum(ks[:j]) for j in ln.blocks]
        assert a[29:32] == (ms.stage_halo(sd, kl), plan.tile, plan.window)
    assert [c[29] for c in calls] == ([12, 36, 60] if alone else [60 if case[0] == "v" else 12])
    assert (ms.mrf_stage.launches, ms.mrf_stage.resblock_launches) == (len(calls),
                                                                       3 * alone)


def _meta_params(cfg, dtype):
    """The upsample weights stage_routes reads (shape and dtype), as meta
    tensors: the production widths without the memory."""
    chans = [(cfg.hifigan_channels >> i, cfg.hifigan_channels >> (i + 1))
             for i in range(len(cfg.upsample_scales))]
    return {"vocoder": {"upsamples": [
        {"w": torch.empty(co, ci, k, dtype=dtype, device="meta")}
        for (ci, co), k in zip(chans, cfg.upsample_kernel_sizes)]}}


def test_v1_routes():
    """stage_routes at V1's production widths: bf16 sends every stage to
    the kernel (each resblock alone; stage 1's k = 11 in three launches); float32 and the f16-staged
    mode take no stage of mixed sizes, and the f16-staged mode no stage of
    several launches.  zerovox medium: every stage the kernel's in every
    mode."""
    assert hifigan.stage_routes(_meta_params(V1, torch.bfloat16), V1) == [True] * 4
    assert hifigan.stage_routes(_meta_params(V1, torch.float32), V1) == [False] * 4
    with f16_staging():
        assert hifigan.stage_routes(_meta_params(V1, torch.float32), V1) == [False] * 4
        assert hifigan.stage_routes(_meta_params(MEDIUM, torch.float32), MEDIUM) == [True] * 4
    for dtype in DTYPES.values():
        assert hifigan.stage_routes(_meta_params(MEDIUM, dtype), MEDIUM) == [True] * 4
    dils = V1.resblock_dilations
    assert ms.kernel_takes(128, dils, (3, 7, 11), 256, 16, 8, torch.bfloat16)
    assert not ms.kernel_takes(128, dils, (3, 7, 11), 256, 16, 8, torch.float32)
    assert ms.kernel_takes(128, dils, (3, 3, 3), 256, 16, 8, torch.float32)
    assert not ms.kernel_takes(128, dils, (3, 6, 11), 256, 16, 8, torch.bfloat16)
    with f16_staging():                     # one size, but a halo only a split holds
        assert ms.stage_segments(256, dils, 11) == ((0, 1), (1, 2), (2, 3))
        assert not ms.kernel_takes(256, dils, 11, 512, 16, 8, torch.float32)


def test_ragged_pack(rng):
    """bf16 resblocks of 3/7/11 pack every conv's taps one after another in
    chain order, (6 * (3 + 7 + 11), C/8, C, 8), each tap's plane the conv's
    weights; float32 and f16-staged weights of mixed sizes are refused."""
    C, dils, ks = 32, V1.resblock_dilations, (3, 7, 11)

    def blocks(dtype):
        return [{cs: [{"w": torch.from_numpy(rng.normal(size=(C, C, k)).astype(np.float32)
                                             ).to(dtype),
                       "b": torch.zeros(C, dtype=dtype)} for _ in ds]
                 for cs in ("convs1", "convs2")} for ds, k in zip(dils, ks)]

    b16 = blocks(torch.bfloat16)
    pk = ms.pack_stage(b16, dils, ks)
    assert tuple(pk.w.shape) == (6 * 21, C // 8, C, 8) and tuple(pk.b.shape) == (18, C)
    tap = 0
    for j, k in enumerate(ks):
        for di in range(3):
            for cs in ("convs1", "convs2"):
                w = b16[j][cs][di]["w"]
                for t in range(k):
                    assert torch.equal(ms.from_planes(pk.w[tap]), w[:, :, t].T)
                    tap += 1
    with pytest.raises(ValueError, match="want \\(32, 32, 3\\)"):
        ms.pack_stage(b16, dils, (3, 3, 11))
    with pytest.raises(ValueError, match="only the bf16 mode"):
        ms.pack_stage(blocks(torch.float32), dils, ks)
    with f16_staging(), pytest.raises(ValueError, match="only the bf16 mode"):
        ms.pack_stage(blocks(torch.float32), dils, ks)


def test_split_pack(rng):
    """At C=256 the bf16 pack holds the convs launch by launch of the long
    stage's route.  V1's stage 1 runs its resblocks alone there (k = 3 and
    k = 7 one launch each, k = 11 one per dilation slot), which is chain
    order, each resblock's convs at its own size; a stage of one size split
    by slot (k = 11 for all three) packs slot 0 of every resblock, then
    slot 1, then slot 2.  pack_bases gives each launch's resblocks their
    first conv and tap, also for V1's three resblocks together (its route
    in one wave of clusters), whose convs are not one run."""
    C, dils = 256, V1.resblock_dilations
    for ks in ((3, 7, 11), (11, 11, 11)):
        blocks = [{cs: [{"w": torch.randn(C, C, k).to(torch.bfloat16), "b": torch.randn(C)}
                        for _ in ds] for cs in ("convs1", "convs2")} for ds, k in zip(dils, ks)]
        pk = ms.pack_stage(blocks, dils, ks)
        taps = pk.w.reshape(-1, C // 8, C, 8)
        assert tuple(pk.b.shape) == (18, C) and taps.shape[0] == 6 * sum(ks)
        routes = [ms.stage_launches(C, dils, ks, (512, 16, 8))]
        if ks == (3, 7, 11):
            routes.append(ms.stage_launches(C, dils, ks, (512, 16, 8), B=1, L_out=512, wave=44))
            assert [[(ln.blocks, ms.pack_bases(C, dils, ks, ln)) for ln in r.launches]
                    for r in routes] == [
                [((0,), ((0,), (0,))), ((1,), ((6,), (18,))), ((2,), ((12,), (60,))),
                 ((2,), ((14,), (82,))), ((2,), ((16,), (104,)))],
                [((0, 1, 2), ((0, 6, 12), (0, 18, 60))), ((0, 1, 2), ((2, 8, 14), (6, 32, 82))),
                 ((0, 1, 2), ((4, 10, 16), (12, 46, 104)))]]
        else:
            assert [ms.pack_bases(C, dils, ks, ln) for ln in routes[0].launches] == [
                ((0, 2, 4), (0, 22, 44)), ((6, 8, 10), (66, 88, 110)),
                ((12, 14, 16), (132, 154, 176))]
        for ln in (ln for r in routes for ln in r.launches):
            for j, conv, tap in zip(ln.blocks, *ms.pack_bases(C, dils, ks, ln)):
                for di in range(*ln.slots):
                    for cs in ("convs1", "convs2"):
                        src = blocks[j][cs][di]
                        assert torch.equal(pk.b[conv], src["b"])
                        for t in range(ks[j]):
                            assert torch.equal(ms.from_planes(taps[tap]), src["w"][:, :, t].T)
                            tap += 1
                        conv += 1


# ------------------------------------- the port against the plain reference

def _small(precision, seed):
    """(cfg, params, Reference, model dict) at SMALL from the benchmark's
    weight arrays: drawn from `seed`, rounded to the served dtype, given to
    params_from_arrays and to the reference alike."""
    cfg = SMALL.replace(compute_dtype=precision)
    model = json.loads(cfg.to_json())
    arrays = weights.draw(model, V1_JSON["assumed"], seed, torch.device("cpu"),
                          DTYPES[precision])
    params = params_from_arrays(arrays, cfg, device="cpu")
    if precision == "bfloat16":
        params = cast_params(params, torch.bfloat16)
    return cfg, params, Reference(arrays, model, "cpu"), model


@pytest.mark.parametrize("precision", list(DTYPES))
def test_vocode_matches_the_reference(precision):
    """The port's vocoder (every stage on mrf_stage's plain version here, at
    each resblock's own size) against the reference's on one mel.  float32:
    exact here (atol 1e-6: the same float32 convs, in another layout; the
    readings are 0).  bfloat16: the kernel's arithmetic, every conv operand
    rounded to bf16 (2^-9 relative) over 4 stages of 6 chained convs, so rms
    within 2 % of the reference's rms (readings 0.22-0.41 %) and max|d|
    within 5 % of max|ref| (0.78-0.90 %)."""
    for seed in (1, 2):
        cfg, params, ref, _ = _small(precision, seed)
        mel = torch.randn(1, cfg.max_seq_len, cfg.num_mels,
                          generator=torch.Generator().manual_seed(seed))
        if precision == "bfloat16":
            mel = mel.bfloat16().float()       # both read the same bf16 mel
        with torch.no_grad():
            got = hifigan.vocode(params, cfg, mel).float()[0]
        want = ref.vocode(mel[0].t())
        assert got.shape == want.shape == (cfg.max_seq_len * cfg.hop_size,)
        if precision == "float32":
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        else:
            d = got - want
            assert d.pow(2).mean().sqrt() <= 0.02 * want.pow(2).mean().sqrt()
            assert d.abs().max() <= 0.05 * want.abs().max()


def test_stream_matches_the_full_run():
    """A stream at the daemon's overlap (16 frames, over V1's 15) equals the
    whole vocode at SMALL (atol 2e-5 / rtol 1e-4, as for zerovox's geometry:
    the same sums on a window as on the whole, up to the convs' blocking)."""
    cfg, params, _, _ = _small("float32", 3)
    mel = torch.randn(1, cfg.max_seq_len, cfg.num_mels, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full = hifigan.vocode(params, cfg, mel).numpy()
    s = StreamingSynthesizer(params, cfg, chunk_frames=24, overlap=16, device="cpu")
    out = torch.cat(list(s.vocode_chunks(mel, -(-cfg.max_seq_len // 24))), dim=1).numpy()
    np.testing.assert_allclose(out[:, :full.shape[1]], full, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("precision", list(DTYPES))
def test_synthesize_matches_the_reference(precision):
    """The whole synthesis (TINY's front, V1's vocoder) against the
    reference on the benchmark's utterances: the same mel length (6 frames a
    phoneme), and PCM16 within 1 LSB in float32 (a last-ulp difference can
    cross a quantisation step) or 2000 LSB in bf16 (the benchmark's own CPU
    test's gate at TINY; the readings here are 93-446)."""
    cfg, params, ref, model = _small(precision, 7)
    mix = {"phonemes": [4, 10], "pool": 8, "style_std": 0.1}
    pool = traffic.make_pool(mix, {**model, "d_model": cfg.d_model}, 7)
    for u in pool[:3]:
        n = len(u.phonemes)
        src = np.zeros((1, cfg.max_n_phonemes), np.int64)
        pun = np.zeros_like(src)
        src[0, :n], pun[0, :n] = u.phonemes, u.puncts
        res = synthesize(params, cfg, src, pun, u.style[None], np.array([n]), device="cpu")
        r = ref.synthesize(*u)
        assert int(res.mel_len[0]) == r["mel_len"] == 6 * n
        pcm = (torch.clamp(res.wav[0].float(), -1, 1) * 32767).to(torch.int16).numpy()
        diff = np.abs(pcm.astype(np.int64) - r["pcm"].astype(np.int64))
        assert diff.max() <= (1 if precision == "float32" else 2000)
