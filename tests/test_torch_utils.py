"""The port's utilities on the CPU: debug taps, the checkpoint converter and
the profiling helpers, each against its JAX counterpart where there is one.

Taps: the same names as the JAX package's capture_run on the same weights
and inputs, each tensor within the stage tolerances of
tests/test_torch_stages.py (features / log_duration atol 5e-5 rtol 1e-4; mel
atol 5e-3 rtol 1e-3; wav atol 1e-3 rtol 1e-3).  Converter: equal tensors and
files equal byte for byte.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.models.pipeline import synthesize as j_synthesize
from zerovox_tpu.utils import convert as jconvert
from zerovox_tpu.utils.debug import capture_run as j_capture_run
from zerovox_tpu.utils.debug import summarize as j_summarize

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.models.pipeline import synthesize
from zerovox_tpu_torch.utils import convert as tconvert
from zerovox_tpu_torch.utils import debug as tdebug
from zerovox_tpu_torch.utils.debug import capture_run, print_taps, summarize, tap
from zerovox_tpu_torch.utils.profiling import StageTimer, device_time, trace

from oracles import torch_ref
from oracles.synthetic import meldec_state_dict, upstream_state_dict

CFG = TINY_CONFIG
TAP_TOL = {"encoder_output": dict(atol=5e-5, rtol=1e-4), "pitch": dict(atol=5e-5, rtol=1e-4),
           "energy": dict(atol=5e-5, rtol=1e-4), "features": dict(atol=5e-5, rtol=1e-4),
           "log_duration": dict(atol=5e-5, rtol=1e-4), "mel": dict(atol=5e-3, rtol=1e-3),
           "dbg": dict(atol=1e-3, rtol=1e-3), "wav": dict(atol=1e-3, rtol=1e-3)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """TINY-size ops gain nothing from intra-op threads, and several test
    workers' thread pools spinning on the same cores cost a lot."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY), CFG, device="cpu")
    return pj, pt


def _inputs(rng, B=1):
    src = rng.integers(0, CFG.num_phonemes + 1, size=(B, CFG.max_n_phonemes))
    pun = rng.integers(0, CFG.num_puncts + 1, size=(B, CFG.max_n_phonemes))
    style = rng.normal(scale=0.1, size=(B, CFG.d_model)).astype(np.float32)
    return src, pun, style


# ----------------------------------------------------------------------- taps

def test_capture_run_matches_jax(rng, model):
    pj, pt = model
    src, pun, style = _inputs(rng)
    ref_out, ref = j_capture_run(lambda p, s, pu, se: j_synthesize(p, J_TINY, s, pu, se),
                                 pj, jnp.asarray(src), jnp.asarray(pun), jnp.asarray(style))
    out, taps = capture_run(synthesize, pt, CFG, src, pun, style, device="cpu")
    assert set(taps) == set(ref) == set(TAP_TOL)
    for name, tol in TAP_TOL.items():
        assert tuple(taps[name].shape) == tuple(ref[name].shape), name
        np.testing.assert_allclose(taps[name].numpy(), np.asarray(ref[name]), err_msg=name, **tol)
    assert taps["wav"] is out.wav and taps["mel"] is out.mel        # the tensors, not copies
    assert taps["dbg"].shape == (1, CFG.max_seq_len * CFG.hop_size, 1)
    plain = synthesize(pt, CFG, src, pun, style, device="cpu")
    np.testing.assert_array_equal(plain.wav.numpy(), out.wav.numpy())
    assert summarize("mel", taps["mel"]) == j_summarize("mel", np.asarray(taps["mel"]))
    assert "sum:" in summarize("wav", out.wav.to(torch.bfloat16))


def test_tap_without_capture_records_nothing(rng, model, monkeypatch, capsys):
    """No capture: tap returns its argument, keeps nothing, and does no work
    on it (a tensor subclass that fails on any operation passes through)."""
    class Untouchable(torch.Tensor):
        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            raise AssertionError(f"tap touched its tensor: {func}")

    x = torch.ones(3).as_subclass(Untouchable)
    assert tap("anything", x) is x
    assert tdebug._capture_ctx.get() is None
    _, taps = capture_run(lambda a: tap("t", a), x)                 # nor with one
    assert taps["t"] is x
    assert tdebug._capture_ctx.get() is None and tap("after", x) is x
    with pytest.raises(ZeroDivisionError):                          # a failure resets it too
        capture_run(lambda: 1 / 0)
    assert tdebug._capture_ctx.get() is None
    print_taps({"a": torch.arange(5.0)})
    assert capsys.readouterr().out.startswith("a [5] = [0.00000, 1.00000, 2.00000")


def test_taps_from_two_threads_do_not_mix(rng, model):
    """A capture in one thread never sees another thread's taps: each
    thread's capture holds its own request's tensors, and a thread without a
    capture records nothing."""
    _, pt = model
    inputs = [_inputs(np.random.default_rng(s)) for s in (1, 2)]
    wants = [synthesize(pt, CFG, *i, device="cpu").wav.numpy() for i in inputs]
    barrier = threading.Barrier(3)
    got = [None, None]

    def captured(i):
        def run():
            barrier.wait(timeout=60)
            return synthesize(pt, CFG, *inputs[i], device="cpu")
        got[i] = capture_run(run)[1]

    def bare():
        barrier.wait(timeout=60)
        for _ in range(3):
            synthesize(pt, CFG, *inputs[0], device="cpu")
        got.append(tdebug._capture_ctx.get())

    threads = [threading.Thread(target=captured, args=(0,)),
               threading.Thread(target=captured, args=(1,)), threading.Thread(target=bare)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert got[2] is None
    for taps, want in zip(got[:2], wants):
        assert set(taps) == set(TAP_TOL)
        np.testing.assert_array_equal(taps["wav"].numpy(), want)
    assert not np.array_equal(wants[0], wants[1])


# ------------------------------------------------------------------ converter

@pytest.fixture(scope="module")
def upstream():
    torch.manual_seed(11)
    fs2 = torch_ref.TorchFS2Encoder(J_TINY).eval()
    dec = torch_ref.TorchStyleTTSDecoder(J_TINY).eval()
    voc = torch_ref.TorchHiFiGAN(J_TINY).eval()
    with torch.no_grad():
        voc.mean.normal_(0.0, 1.0)
        voc.scale.uniform_(0.5, 2.0)
    return (upstream_state_dict(fs2, dec), meldec_state_dict(voc),
            {"mean": voc.mean, "scale": voc.scale})


def test_convert_helpers_match_jax(rng):
    for name in ("_phoneme_encoder._encoder.layer_stack.0.slf_attn.w_qs.weight",
                 "_phoneme_encoder._variance_adaptor.energy_predictor.linear_layer.bias",
                 "_meldec.upsamples.1.1.weight_v"):
        assert tconvert.shorten_tensor_name(name) == jconvert.shorten_tensor_name(name)
    assert tconvert.shorten_tensor_name(
        "_phoneme_encoder._encoder.layer_stack.0.slf_attn.w_qs.weight") \
        == "_pe._enc.laystk.0.slf_attn.w_qs.w"
    v = rng.normal(size=(6, 3, 5)).astype(np.float32)
    g = rng.uniform(0.5, 2.0, size=(6, 1, 1)).astype(np.float32)
    folded = tconvert.fold_weight_norm(v, g)
    np.testing.assert_array_equal(folded, jconvert.fold_weight_norm(v, g))
    np.testing.assert_allclose(np.sqrt((folded ** 2).sum(axis=(1, 2))), g[:, 0, 0], rtol=1e-6)


def test_convert_state_dict_matches_jax(upstream):
    sd, meldec, stats = upstream
    ours = tconvert.convert_state_dict(sd, CFG, meldec, stats)
    theirs = jconvert.convert_state_dict(sd, J_TINY, meldec, stats)
    assert list(ours) == list(theirs)                              # names, in order
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ours["sinusoid_encoding_table"].shape == (CFG.max_seq_len + 1, CFG.d_model)
    assert any(v.dtype == np.float16 for v in ours.values())
    assert not any(k.endswith(("weight_g", "weight_v")) for k in ours)


def test_convert_checkpoint_files_equal_byte_for_byte(upstream, tmp_path):
    sd, meldec, stats = upstream
    ours, theirs = str(tmp_path / "t.gguf"), str(tmp_path / "j.gguf")
    tconvert.convert_checkpoint(ours, sd, CFG, meldec_state_dict=meldec, hifigan_stats=stats)
    jconvert.convert_checkpoint(theirs, sd, J_TINY, meldec_state_dict=meldec,
                                hifigan_stats=stats)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    cfg, params = tparams.load_params(ours, device="cpu")           # and the port loads it
    assert cfg.to_json() == CFG.to_json()
    src, pun, style = _inputs(np.random.default_rng(0))
    wav = synthesize(params, cfg, src, pun, style, device="cpu").wav
    assert torch.isfinite(wav).all() and wav.abs().max() > 0


def test_convert_cli_end_to_end(upstream, tmp_path):
    """`python -m zerovox_tpu_torch.utils.convert` on an upstream-layout
    directory tree gives the file the library call gives."""
    import h5py
    import yaml
    sd, meldec, stats = upstream
    cfg = CFG
    mdir, hdir = tmp_path / "model", tmp_path / "hifigan"
    (mdir / "checkpoints").mkdir(parents=True)
    hdir.mkdir()
    ycfg = {
        "model": {"max_seq_len": cfg.max_seq_len, "num_phonemes": cfg.num_phonemes,
                  "num_puncts": cfg.num_puncts, "max_n_phonemes": cfg.max_n_phonemes,
                  "emb_dim": cfg.emb_dim, "punct_emb_dim": cfg.punct_emb_dim,
                  "encoder": {"fs2_layer": cfg.encoder_layer, "fs2_head": cfg.encoder_head,
                              "vp_filter_size": cfg.vp_filter_size,
                              "vp_kernel_size": cfg.vp_kernel_size, "ve_n_bins": cfg.ve_n_bins},
                  "decoder": {"n_head": cfg.encoder_head,
                              "conv_filter_size": cfg.conv_filter_size,
                              "conv_kernel_size": list(cfg.conv_kernel_size)}},
        "audio": {"sampling_rate": cfg.sampling_rate, "num_mels": cfg.num_mels,
                  "hop_size": cfg.hop_size},
        "hifigan": {"upsample_scales": list(cfg.upsample_scales),
                    "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
                    "channels": cfg.hifigan_channels, "num_resblocks": cfg.num_resblocks,
                    "residual_dim": cfg.residual_dim,
                    "resblock_dilations": [list(d) for d in cfg.resblock_dilations]},
    }
    (mdir / "modelcfg.yaml").write_text(yaml.safe_dump(ycfg))
    assert tconvert.config_from_model_yaml(ycfg).to_json() \
        == jconvert.config_from_model_yaml(ycfg).to_json()
    torch.save({"state_dict": sd}, str(mdir / "checkpoints" / "epoch1.ckpt"))
    torch.save({"model": {"generator": meldec}}, str(hdir / "checkpoint.pkl"))
    with h5py.File(str(hdir / "stats.h5"), "w") as f:
        f["mean"] = stats["mean"].numpy()
        f["scale"] = stats["scale"].numpy()
    out_cli, out_lib = str(tmp_path / "cli.gguf"), str(tmp_path / "lib.gguf")
    assert tconvert.main(["--model-dir", str(mdir), "--hifigan-dir", str(hdir),
                          "--out", out_cli]) == 0
    tconvert.convert_checkpoint(out_lib, sd, tconvert.config_from_model_yaml(ycfg),
                                meldec_state_dict=meldec, hifigan_stats=stats)
    with open(out_cli, "rb") as a, open(out_lib, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(SystemExit):                                 # no modelcfg.yaml there
        tconvert.main(["--model-dir", str(hdir), "--out", out_cli])


# ------------------------------------------------------------------ profiling

def test_device_time_on_cpu_tensors():
    calls = []

    def work(x, seconds):
        calls.append(x)
        time.sleep(seconds)

    x = torch.zeros(4)
    ms = device_time(work, x, 0.02, iters=3, reps=2)
    assert len(calls) == 1 + 3 * 2                                   # one warm-up, then reps x iters
    assert 18.0 < ms < 200.0                                         # per call, in milliseconds
    for bad in (dict(iters=0), dict(reps=0)):
        with pytest.raises(ValueError):
            device_time(work, x, 0.0, **bad)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):          # no silent CPU timing
            device_time(work, x, 0.0, iters=1, reps=1, cuda=True)


def test_stage_timer_and_trace(tmp_path):
    t = StageTimer()
    with t.section("front"):
        time.sleep(0.02)
    with t.section("vocoder"):
        time.sleep(0.01)
    assert [n for n, _ in t.records] == ["front", "vocoder"]
    assert t.records[0][1] >= 0.02 and t.records[1][1] >= 0.01
    lines = t.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("front") and lines[0].endswith("%")
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("sum" in e.key for e in prof.key_averages())
