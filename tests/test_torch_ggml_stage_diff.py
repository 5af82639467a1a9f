"""The port's staged stages against the REFERENCE'S OWN C++ model classes.

The port's counterpart of tests/test_ggml_stage_diff.py (TINY) and
tests/test_ggml_stage_diff_prod.py (production geometry), with their bands:
zerovox_tpu_torch/refharness/ compiles the reference's FS2Encoder,
StyleTTSDecoder and HiFiGAN UNMODIFIED against its vendored ggml build
(the tree at $ZEROVOX_REF), runs them in a worker process
(refharness/stage_proc.py), and each test diffs the port's stages, on the
CPU under ops.conv.f16_staging (the simulation of ggml's f16 conv weights
and f16 im2col), at one eval() boundary.

Every test skips where the harness is unavailable (no reference tree, or no
cmake / ninja / C++ compiler): the reference tree is not in the repository
yet.  The fixtures assert the duration margins, as the JAX files do.
"""

import numpy as np
import pytest
import torch

from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
from zerovox_tpu_torch.models import fs2_encoder, hifigan, styletts_decoder
from zerovox_tpu_torch.models.pipeline import synthesize
from zerovox_tpu_torch.ops.conv import f16_staging
from zerovox_tpu_torch.ops.length_regulator import durations_from_log, length_regulate
from zerovox_tpu_torch.ops.misc import bucketize
from zerovox_tpu_torch.params import load_params
from zerovox_tpu_torch.refharness.build import get_stage_harness
from zerovox_tpu_torch.refharness.stage_proc import RefStages
from zerovox_tpu_torch.utils.debug import capture_run
from zerovox_tpu_torch.utils.verify import probe_utterance

from oracles.synthetic import build_synthetic_gguf

# the JAX production file's fixture: duration margin 5.4e-3 frames, 691 mel frames
GGUF_SEED, INPUT_SEED = 25, 7


def _harness():
    lib, reason = get_stage_harness()
    if lib is None:
        pytest.skip(f"reference stage harness unavailable: {reason}")
    return lib


def _stage_fixture(tmp_path_factory, cfg, seed, name):
    lib = _harness()
    path = str(tmp_path_factory.mktemp("torch_stagediff") / name)
    modules = build_synthetic_gguf(path, cfg, seed=seed, duration_bias=1.5)
    ref = RefStages(lib, path, cfg)
    _, params = load_params(path, device="cpu")
    return cfg, params, ref, modules


@pytest.fixture(scope="module")
def tiny_stage(tmp_path_factory):
    cfg, params, ref, modules = _stage_fixture(tmp_path_factory, TINY_CONFIG, 11, "tiny.gguf")
    yield cfg, params, ref
    ref.free()
    del modules


@pytest.fixture(scope="module")
def prod_stage(tmp_path_factory):
    cfg, params, ref, modules = _stage_fixture(tmp_path_factory, ZeroVoxConfig(), GGUF_SEED,
                                               "prod.gguf")
    yield cfg, params, ref
    ref.free()
    del modules


def _assert_duration_margin(log_dur, min_margin=1e-3):
    """exp(ld) - 1 + 0.5's distance from an integer decides the reference's
    (int32) cast (fs2encoder.cpp:624-625): f16 noise must not flip one."""
    d = np.exp(np.asarray(log_dur, dtype=np.float64)) - 1.0 + 0.5
    margin = np.abs(d - np.round(d)).min()
    assert margin > min_margin, (
        f"duration rounding margin {margin:.2e} too small for a stable differential test")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _encode(params, cfg, src, pun, style, nph=None):
    with torch.no_grad(), f16_staging():
        feat, log_dur = fs2_encoder.encode(params, cfg, _t(src).long()[None],
                                           _t(pun).long()[None], _t(style)[None])
        hidden, total = length_regulate(
            feat, durations_from_log(log_dur, cfg.max_seq_len), cfg.max_seq_len,
            num_phonemes=None if nph is None else torch.tensor([nph]))
    return feat, log_dur, hidden, total


def test_stage_encoder_diff(tiny_stage):
    cfg, params, ref = tiny_stage
    src, pun, style = probe_utterance(cfg, seed=7)
    ref_x, ref_len = ref.encoder(src, pun, style, cfg.max_n_phonemes)
    _, log_dur, hidden, total = _encode(params, cfg, src, pun, style)
    _assert_duration_margin(log_dur[0].numpy())
    assert int(total[0]) == ref_len > cfg.max_seq_len // 4
    np.testing.assert_allclose(hidden[0].numpy(), ref_x, atol=5e-5, rtol=1e-4)


def test_stage_encoder_truncation(tiny_stage):
    cfg, params, ref = tiny_stage
    src, pun, style = probe_utterance(cfg, seed=9)
    nph = cfg.max_n_phonemes // 2
    ref_x, ref_len = ref.encoder(src, pun, style, nph)
    _, log_dur, hidden, total = _encode(params, cfg, src, pun, style, nph)
    _assert_duration_margin(log_dur[0, :nph].numpy())
    assert int(total[0]) == ref_len
    np.testing.assert_allclose(hidden[0].numpy(), ref_x, atol=5e-5, rtol=1e-4)


def test_stage_decoder_diff(tiny_stage):
    cfg, params, ref = tiny_stage
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(cfg.max_seq_len, cfg.d_model)).astype(np.float32)
    style = rng.normal(scale=0.1, size=cfg.d_model).astype(np.float32)
    ref_mel = ref.decoder(hidden, style)
    with torch.no_grad(), f16_staging():
        mel = styletts_decoder.decode(params, cfg, _t(hidden)[None], _t(style)[None])
    np.testing.assert_allclose(mel[0].numpy(), ref_mel, atol=5e-3, rtol=1e-3)


def test_stage_hifigan_diff(tiny_stage):
    cfg, params, ref = tiny_stage
    rng = np.random.default_rng(4)
    mean = params["vocoder"]["mean"].numpy()
    scale = params["vocoder"]["scale"].numpy()
    mel = (rng.normal(size=(cfg.max_seq_len, cfg.num_mels)) * scale + mean).astype(np.float32)
    ref_wav = ref.vocoder(mel)
    with torch.no_grad(), f16_staging():
        wav = hifigan.vocode(params, cfg, _t(mel)[None])
    np.testing.assert_allclose(wav[0].numpy(), ref_wav, atol=1e-3, rtol=1e-3)


def test_stage_full_chain_diff(tiny_stage):
    cfg, params, ref = tiny_stage
    src, pun, style = probe_utterance(cfg, seed=7)
    ref_x, ref_len = ref.encoder(src, pun, style, cfg.max_n_phonemes)
    ref_mel = ref.decoder(ref_x, style)
    ref_wav = ref.vocoder(ref_mel)
    with torch.no_grad(), f16_staging():
        out = synthesize(params, cfg, src[None], pun[None], style[None], device="cpu")
    _assert_duration_margin(out.log_duration[0].numpy())
    assert int(out.mel_len[0]) == ref_len
    np.testing.assert_allclose(out.mel[0].numpy(), ref_mel, atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(out.wav[0].numpy(), ref_wav, atol=2e-2, rtol=1e-2)


def _bucket_margins(pred, n_bins):
    """Distance of pred * (n_bins - 1) from its nearest bucket boundary (at
    half-integers; the clamp regions map to margin 0.5)."""
    v = np.asarray(pred, dtype=np.float64).reshape(-1) * (n_bins - 1)
    v = np.clip(v, 0.0, float(n_bins - 1))
    return np.abs((v - np.floor(v)) - 0.5)


def test_stage_encoder_diff_production(prod_stage):
    """At production geometry the length regulator's expansion must agree
    exactly, and every phoneme whose frames disagree must be explained as a
    pitch / energy embedding-row swap at a near-boundary bucket decision
    (tests/test_ggml_stage_diff_prod.py's flip audit); the other frames
    within atol 5e-4 / rtol 1e-3."""
    cfg, params, ref = prod_stage
    src, pun, style = probe_utterance(cfg, seed=INPUT_SEED)
    P = cfg.max_n_phonemes
    ref_x, ref_len = ref.encoder(src, pun, style, P)
    (feat, log_dur, hidden, total), taps = capture_run(_encode, params, cfg, src, pun, style)
    _assert_duration_margin(log_dur[0].numpy(), min_margin=2e-3)
    assert int(total[0]) == ref_len > cfg.max_seq_len // 4

    n = cfg.ve_n_bins
    pitch_m = _bucket_margins(taps["pitch"][0].numpy(), n)
    energy_m = _bucket_margins(taps["energy"][0].numpy(), n)
    pe = params["encoder"]["pitch_emb"].double().numpy()
    ee = params["encoder"]["energy_emb"].double().numpy()
    pb = bucketize(taps["pitch"], n).reshape(-1).numpy()
    eb = bucketize(taps["energy"], n).reshape(-1).numpy()
    dur_h = durations_from_log(log_dur, cfg.max_seq_len)[0].numpy().astype(int)
    starts = np.concatenate([[0], np.cumsum(dur_h)[:-1]]).astype(int)
    h = hidden[0].numpy()
    fdiff = np.abs(h - ref_x).max(axis=1)

    bad, clean_frames = [], np.ones(cfg.max_seq_len, bool)
    for i in range(P):
        lo, hi = starts[i], min(starts[i] + dur_h[i], cfg.max_seq_len)
        if hi > lo and fdiff[lo:hi].max() > 1e-3:
            bad.append(i)
            clean_frames[lo:hi] = False
    assert len(bad) <= P // 6, f"{len(bad)}/{P} phonemes disagree: {bad}"

    pitch_flipped = set()
    for i in bad:
        d = ref_x[starts[i]].astype(np.float64) - feat[0][i].double().numpy()
        best = (np.inf, 0, eb[i])
        for dp in range(-2, 3):
            b2 = int(np.clip(pb[i] + dp, 0, n - 1))
            rem = d - (pe[b2] - pe[pb[i]])
            res = np.abs((ee - ee[eb[i]]) - rem).max(axis=1)
            e2 = int(res.argmin())
            if res[e2] < best[0]:
                best = (res[e2], b2 - pb[i], e2)
        residual, dp, _ = best
        assert residual < 5e-3, (
            f"phoneme {i}: feature diff (max {np.abs(d).max():.3f}) is not an "
            f"embedding-row swap (best residual {residual:.3e})")
        if dp != 0:
            assert pitch_m[i] < 0.1, (
                f"phoneme {i}: pitch bucket swapped by {dp} at margin {pitch_m[i]:.3f}")
            pitch_flipped.add(i)
    for i in bad:
        if i in pitch_flipped or any(abs(i - j) <= 2 for j in pitch_flipped):
            continue
        assert energy_m[i] < 0.1, (
            f"phoneme {i}: energy bucket swapped at margin {energy_m[i]:.3f} with no "
            f"nearby pitch flip")
    np.testing.assert_allclose(h[clean_frames], ref_x[clean_frames], atol=5e-4, rtol=1e-3)


def test_stage_decoder_diff_production(prod_stage):
    cfg, params, ref = prod_stage
    src, pun, style = probe_utterance(cfg, seed=INPUT_SEED)
    hidden, _ = ref.encoder(src, pun, style, cfg.max_n_phonemes)
    ref_mel = ref.decoder(hidden, style)
    with torch.no_grad(), f16_staging():
        mel = styletts_decoder.decode(params, cfg, _t(hidden)[None], _t(style)[None])
    np.testing.assert_allclose(mel[0].numpy(), ref_mel, atol=5e-3, rtol=1e-3)


def test_stage_hifigan_diff_production(prod_stage):
    cfg, params, ref = prod_stage
    src, pun, style = probe_utterance(cfg, seed=INPUT_SEED)
    hidden, _ = ref.encoder(src, pun, style, cfg.max_n_phonemes)
    ref_mel = ref.decoder(hidden, style)
    ref_wav = ref.vocoder(ref_mel)
    with torch.no_grad(), f16_staging():
        wav = hifigan.vocode(params, cfg, _t(ref_mel)[None])
    np.testing.assert_allclose(wav[0].numpy(), ref_wav, atol=2e-3, rtol=1e-3)
