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
    every stage in the bf16 kernel (stage 1, 256 channels, in one launch
    per dilation slot), no stage of mixed sizes in float32 or under
    f16_staging, and medium's plans as they were;
  * the ragged pack of the bf16 weights, launch by launch for stage 1;
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
    """V1 in bf16: at C=256 no window of the design holds a 60-row halo, so
    stage 1 runs one launch per dilation slot, at halos 10 / 20 / 30: tiles
    of 72 / 88 / 60 rows in windows of 92 / 128 / 120 (chunks of 64, 16 and
    16 input channels: with 64 the last two would leave tiles of 42 and
    12); at C = 128 / 64 / 32 one launch, tiles of 72 / 392 / 392 rows in
    windows of 192 / 512 / 512, the operand margin the k=11 resblock's
    largest tap shift, 5 * 5 = 25 rows."""
    dils, kr = V1.resblock_dilations, V1.resblock_kernels
    with pytest.raises(ValueError, match="halo 60 leaves no room"):
        ms.bf16_plan(256, dils, kr, 512, 16, 8)
    segments = ms.stage_segments(256, dils, kr)
    assert segments == ((0, 1), (1, 2), (2, 3))
    split = [ms.bf16_plan(256, ms.segment_dilations(dils, seg), kr,
                          *((512, 16, 8) if seg == segments[0] else ()))
             for seg in segments]
    assert [(p.tile, p.window, p.kb, p.margin) for p in split] == [
        (72, 92, 64, 5), (88, 128, 16, 15), (60, 120, 16, 25)]
    assert ms.bf16_plan(256, ((3,),) * 3, kr, kb=64).tile == 42
    assert ms.bf16_plan(256, ((5,),) * 3, kr, kb=64).tile == 12
    for C, _, _, _ in V1_STAGES[1:]:
        assert ms.stage_segments(C, dils, kr) == ((0, 3),)
    for C, _, _, _ in MEDIUM_STAGES:
        assert ms.stage_segments(C, MEDIUM.resblock_dilations, 3) == ((0, 3),)
    plans = [ms.bf16_plan(C, dils, kr, cin, k, s) for C, cin, s, k in V1_STAGES[1:]]
    assert [p.tile for p in plans] == [72, 392, 392]
    assert [p.window for p in plans] == [192, 512, 512]
    assert [p.margin for p in plans] == [25] * 3
    with pytest.raises(ValueError, match="only the bf16 mode"):
        ms.tile_plan(128, dils, kr, 256, 16, 8)


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
    the kernel (stage 1 in three launches); float32 and the f16-staged
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
    """At C=256 (V1's stage 1, three launches) the bf16 pack holds each
    launch's convs as one run: slot 0 of every resblock, then slot 1, then
    slot 2, each resblock's convs at its own size; segment_weights gives
    each launch its run of taps and biases."""
    C, dils, ks = 256, V1.resblock_dilations, (3, 7, 11)
    blocks = [{cs: [{"w": torch.randn(C, C, k).to(torch.bfloat16), "b": torch.randn(C)}
                    for _ in ds] for cs in ("convs1", "convs2")} for ds, k in zip(dils, ks)]
    pk = ms.pack_stage(blocks, dils, ks)
    assert tuple(pk.w.shape) == (6 * 21, C // 8, C, 8) and tuple(pk.b.shape) == (18, C)
    launches = list(ms.segment_weights(pk.w, pk.b, dils, ks, ms.stage_segments(C, dils, ks)))
    assert [(sd, w.shape[0], b.shape[0]) for sd, w, b in launches] == [
        (((d,),) * 3, 2 * 21, 6) for d in (1, 3, 5)]
    for di, (_, w, b) in enumerate(launches):
        tap = conv = 0
        for j, k in enumerate(ks):
            for cs in ("convs1", "convs2"):
                src = blocks[j][cs][di]
                assert torch.equal(b[conv], src["b"])
                for t in range(k):
                    assert torch.equal(ms.from_planes(w[tap]), src["w"][:, :, t].T)
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
