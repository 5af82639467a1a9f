"""The port's multi-device regimes (zerovox_tpu_torch.parallel) on the CPU,
held against the JAX package's on meshes of the same shape.

The port's meshes are torch.device("cpu") repeated (the repeated-device
mesh that `make_mesh(devices=...)` accepts, the counterpart of XLA's forced
host device count); the JAX meshes are jax.devices()[:n] of the 8 virtual
CPU devices (tests/conftest.py).  Weights cross with params_to_arrays ->
params_from_arrays, inputs are the same numpy arrays.  Tolerances are the
JAX tests' (tests/test_parallel.py): TP atol 2e-4 / rtol 1e-3 (the
row-parallel sums add in another order), the time-parallel vocoder against
the full run atol 2e-5 / rtol 1e-4 (the stream gate), the pipeline against
the single-device path atol 2e-5 / rtol 1e-4.  The JAX compiles are shared
through module-scoped fixtures: one program per mesh shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
import zerovox_tpu.parallel as jpar
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.config import ZeroVoxConfig as JConfig
from zerovox_tpu.parallel.infer import time_shard_geometry as j_geometry

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch import parallel as tpar
from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
from zerovox_tpu_torch.models import hifigan
from zerovox_tpu_torch.models.pipeline import synthesize
from zerovox_tpu_torch.parallel.infer import time_shard_geometry

CFG = TINY_CONFIG
TP = dict(atol=2e-4, rtol=1e-3)
STREAM = dict(atol=2e-5, rtol=1e-4)
CPU = torch.device("cpu")
B = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """TINY-size ops gain nothing from intra-op threads, and several test
    workers' thread pools on the same cores cost a lot."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY), CFG, device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    src = rng.integers(0, CFG.num_phonemes + 1, size=(B, CFG.max_n_phonemes)).astype(np.int32)
    pun = rng.integers(0, CFG.num_puncts + 1, size=(B, CFG.max_n_phonemes)).astype(np.int32)
    style = rng.normal(scale=0.1, size=(B, CFG.d_model)).astype(np.float32)
    n = np.full((B,), CFG.max_n_phonemes, np.int32)
    return src, pun, style, n


def cpu_mesh(data, model):
    return tpar.make_mesh(data=data, model=model, devices=[CPU] * (data * model))


def jax_run(weights, batch, data, model, jcfg=J_TINY, **kw):
    mesh = jpar.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    sp, fn = jpar.make_sharded_synthesize(jcfg, mesh, weights[0], **kw)
    return fn(sp, *jpar.shard_batch(tuple(jnp.asarray(a) for a in batch), mesh))


def port_run(weights, batch, data, model, cfg=CFG, **kw):
    mesh = cpu_mesh(data, model)
    sp, fn = tpar.make_sharded_synthesize(cfg, mesh, weights[1], **kw)
    return fn(sp, *tpar.shard_batch(batch, mesh))


def _leaves(specs):
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in _leaves(v)]
    if isinstance(specs, list):
        return [x for v in specs for x in _leaves(v)]
    return [specs]


def test_mesh_shapes_and_errors():
    """Mesh.shape and .devices read as in JAX; the same errors, word for word."""
    mesh = cpu_mesh(2, 2)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.devices.shape == (2, 2) and list(mesh.devices.flat) == [CPU] * 4
    assert tpar.make_mesh(model=2, devices=[CPU] * 4).shape == {"data": 2, "model": 2}
    for kw in (dict(data=3, model=1), dict(model=3)):
        with pytest.raises(ValueError) as want:
            jpar.make_mesh(devices=jax.devices()[:4], **kw)
        with pytest.raises(ValueError) as got:
            tpar.make_mesh(devices=[CPU] * 4, **kw)
        assert str(got.value) == str(want.value)
    for spec in ("4", "a,b", "0,1", "2,-1", "1,2,3"):
        with pytest.raises(ValueError) as want:
            jpar.parse_mesh_spec(spec)
        with pytest.raises(ValueError) as got:
            tpar.parse_mesh_spec(spec)
        assert str(got.value) == str(want.value)
    assert tpar.parse_mesh_spec("4,2") == jpar.parse_mesh_spec("4,2") == (4, 2)


@pytest.mark.parametrize("hifigan_channels", [32, 128])
def test_param_partition_specs_match_jax(hifigan_channels):
    """Leaf for leaf, the port splits the axis JAX's PartitionSpec names, in
    the port's layout (Linear and Conv1d leaves are the JAX leaves
    transposed, so JAX axis a is the port's axis ndim - 1 - a), and
    replicates what JAX replicates.  128 channels take the vocoder's
    width rule (C >= 64) on its first stages."""
    cfg = CFG.replace(hifigan_channels=hifigan_channels)
    jcfg = J_TINY.replace(hifigan_channels=hifigan_channels)
    pj = jparams.init_params(jcfg, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, jcfg), cfg, device="cpu")
    jspecs = jpar.param_partition_specs(pj, jcfg)
    tspecs = tpar.param_partition_specs(pt)
    n_split = 0
    for path, (_, kind) in tparams.gguf_name_map(cfg).items():
        js, ts = jspecs, tspecs
        for k in path:
            js, ts = js[k], ts[k]
        node = pt
        for k in path:
            node = node[k]
        axes = [i for i, a in enumerate(js) if a == "model"]
        if not axes:
            assert ts is None, path
            continue
        want = node.dim() - 1 - axes[0] if kind in ("linear", "conv") else axes[0]
        assert ts == want, (path, js, ts)
        n_split += 1
    assert n_split > 40


@pytest.mark.parametrize("data,model", [(4, 1), (2, 2), (1, 4)])
def test_sharded_synthesize_matches_jax(weights, batch, data, model):
    """Pure DP (4, 1), TP with the time-sharded vocoder (2, 2) and (1, 4)
    (2 heads over 4 devices: half a head per device): mel and wav within
    the JAX tests' TP tolerance of JAX's regime on the same mesh shape,
    mel_len equal."""
    want = jax_run(weights, batch, data, model)
    got = port_run(weights, batch, data, model)
    np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(want.mel_len))
    np.testing.assert_allclose(got.mel.numpy(), np.asarray(want.mel), **TP)
    np.testing.assert_allclose(got.wav.numpy(), np.asarray(want.wav), **TP)
    np.testing.assert_allclose(got.log_duration.numpy(), np.asarray(want.log_duration), **TP)


@pytest.mark.parametrize("hifigan_channels", [32, 128])
def test_channel_sharded_fallback_matches_jax(weights, batch, hifigan_channels):
    """time_shard_vocoder=False: the vocoder channel-sharded (plain), held
    against JAX's GSPMD-partitioned folded vocoder on a (2, 2) mesh from the
    same arrays, and against the port's time-sharded run.  At 32 channels
    no vocoder conv is split (the width rule takes C >= 64); at 128 the
    input conv, the first upsample and the first stage's resblock convs
    are, so the split products run against JAX too.  The biases init_params
    leaves at zero are drawn at random, so that a bias added on the wrong
    side of a gather shows."""
    cfg = CFG.replace(hifigan_channels=hifigan_channels)
    jcfg = J_TINY.replace(hifigan_channels=hifigan_channels)
    rng = np.random.default_rng(hifigan_channels)
    arrays = {k: rng.normal(scale=0.05, size=a.shape).astype(np.float32) if not a.any() else a
              for k, a in jparams.params_to_arrays(jparams.init_params(jcfg, seed=0),
                                                   jcfg).items()}
    weights = (jparams.params_from_arrays(arrays, jcfg),
               tparams.params_from_arrays(arrays, cfg, device="cpu"))
    n_split = sum(s is not None for s in _leaves(tpar.param_partition_specs(weights[1])["vocoder"]))
    assert (n_split > 0) == (hifigan_channels >= 64), n_split
    want = jax_run(weights, batch, 2, 2, jcfg, time_shard_vocoder=False)
    got = port_run(weights, batch, 2, 2, cfg, time_shard_vocoder=False)
    np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(want.mel_len))
    np.testing.assert_allclose(got.mel.numpy(), np.asarray(want.mel), **TP)
    np.testing.assert_allclose(got.wav.numpy(), np.asarray(want.wav), **TP)
    np.testing.assert_allclose(got.wav.numpy(), port_run(weights, batch, 2, 2, cfg).wav.numpy(),
                               **TP)


def test_channel_sharded_vocoder_splits_wide_convs(weights, batch):
    """At 128 vocoder channels the fallback splits the input conv, the
    upsamples and resblock convs of >= 64 channels: the result still
    equals the single-device pipeline within the TP tolerance."""
    cfg = CFG.replace(hifigan_channels=128)
    params = tparams.init_params(cfg, seed=3, device="cpu")
    ref = synthesize(params, cfg, *batch, device="cpu")
    mesh = cpu_mesh(1, 2)
    sp, fn = tpar.make_sharded_synthesize(cfg, mesh, params, time_shard_vocoder=False)
    assert isinstance(sp[0, 1].params["vocoder"]["upsamples"][0]["w"], torch.Tensor)
    assert sp[0, 1].params["vocoder"]["upsamples"][0]["w"].shape[0] == 32
    got = fn(sp, *batch)
    np.testing.assert_allclose(got.wav.numpy(), ref.wav.numpy(), **TP)


def test_time_shard_geometry_gate(weights):
    """The same geometry as JAX's; an indivisible max_seq_len takes the
    channel-sharded fallback by default and raises only on an explicit
    time_shard_vocoder=True, with JAX's message."""
    for n in (1, 2, 3, 4, 8):
        assert time_shard_geometry(CFG, n) == j_geometry(J_TINY, n)
    assert time_shard_geometry(ZeroVoxConfig(), 2) == j_geometry(JConfig(), 2) == (750, 18, 786)
    assert time_shard_geometry(ZeroVoxConfig(), 4) == j_geometry(JConfig(), 4) == (375, 18, 411)
    cfg = CFG.replace(max_seq_len=CFG.max_seq_len + 1)
    jcfg = J_TINY.replace(max_seq_len=J_TINY.max_seq_len + 1)
    assert time_shard_geometry(cfg, 4) is None and j_geometry(jcfg, 4) is None
    params = tparams.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError) as got:
        tpar.make_sharded_synthesize(cfg, cpu_mesh(2, 4), params, time_shard_vocoder=True)
    with pytest.raises(ValueError) as want:
        jpar.make_sharded_synthesize(jcfg, jpar.make_mesh(data=2, model=4),
                                     jparams.init_params(jcfg, seed=0), time_shard_vocoder=True)
    assert str(got.value) == str(want.value)
    sp, fn = tpar.make_sharded_synthesize(cfg, cpu_mesh(1, 4), params)   # the fallback
    assert sp[0, 0].packed is None
    assert fn(sp, *(a[:1] for a in _inputs(cfg))).wav.shape == (1, cfg.wav_len)


def _inputs(cfg, n=1, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.num_phonemes + 1, size=(n, cfg.max_n_phonemes)),
            rng.integers(0, cfg.num_puncts + 1, size=(n, cfg.max_n_phonemes)),
            rng.normal(scale=0.1, size=(n, cfg.d_model)).astype(np.float32),
            np.full((n,), cfg.max_n_phonemes))


def test_time_parallel_vocoder_matches_full_run(weights):
    """Windows fanned over 4 devices reproduce the full one-device vocoder
    run (the stream gate; on the CPU the windows compute the same sums, so
    it is bitwise equal here), after a warm-up over every window on every
    device."""
    _, pt = weights
    rng = np.random.default_rng(1)
    mel = torch.as_tensor(rng.normal(size=(2, CFG.max_seq_len, CFG.num_mels)), dtype=torch.float32)
    full = hifigan.vocode(pt, CFG, mel).numpy()
    tpv = tpar.TimeParallelVocoder(pt, CFG, devices=[CPU] * 4, chunk_frames=16, overlap=8)
    tpv.warmup()
    wav = tpv.vocode(mel)
    assert wav.shape == full.shape
    np.testing.assert_allclose(wav, full, **STREAM)
    short = tpv.vocode(mel, mel_len=[20, 9])             # two windows of 16 cover 20 frames
    assert short.shape == (2, 32 * CFG.hop_size)
    np.testing.assert_allclose(short, full[:, :short.shape[1]], **STREAM)


def test_pipeline_matches_single_device(weights, batch):
    """Front and vocoder on two devices (the one CPU named twice) reproduce
    the single-device pipeline."""
    _, pt = weights
    ref = synthesize(pt, CFG, *batch, device="cpu")
    pipe = tpar.PipelinedTTS(pt, CFG, front_device="cpu", back_device="cpu")
    out = pipe.run([batch, batch])
    assert len(out) == 2
    for wav, mel_len in out:
        np.testing.assert_array_equal(mel_len, ref.mel_len.numpy())
        np.testing.assert_allclose(wav, ref.wav.numpy(), **STREAM)


def test_pipeline_bounded_staging(weights, batch, monkeypatch):
    """run_iter keeps at most max_in_flight utterances launched and not yet
    fetched, keeps the input order at any window, and max_in_flight < 1
    raises."""
    _, pt = weights
    feed = [tuple(a[i:i + 1] for a in batch) for i in range(B)] + [tuple(a[:1] for a in batch)]
    pipe = tpar.PipelinedTTS(pt, CFG, "cpu", "cpu", max_in_flight=2)
    pipe.warmup()
    staged, peak = [0], [0]
    dispatch, fetch = pipe._dispatch, pipe._fetch

    def counting_dispatch(b):
        staged[0] += 1
        peak[0] = max(peak[0], staged[0])
        return dispatch(b)

    def counting_fetch(p):
        staged[0] -= 1
        return fetch(p)

    monkeypatch.setattr(pipe, "_dispatch", counting_dispatch)
    monkeypatch.setattr(pipe, "_fetch", counting_fetch)
    out2 = list(pipe.run_iter(feed))
    assert len(out2) == len(feed) and peak[0] == 2 and staged[0] == 0
    out1 = tpar.PipelinedTTS(pt, CFG, "cpu", "cpu", max_in_flight=1).run(feed)
    for (w1, l1), (w2, l2) in zip(out1, out2):
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(out2[0][0], out2[-1][0])
    with pytest.raises(ValueError, match="max_in_flight"):
        tpar.PipelinedTTS(pt, CFG, "cpu", "cpu", max_in_flight=0)


def test_pipeline_masked(weights, batch):
    """PipelinedTTS honours use_attention_mask: a masked config with short
    num_phonemes matches the single-device masked pipeline and differs from
    the unmasked one."""
    _, pt = weights
    cfg = CFG.replace(use_attention_mask=True)
    src, pun, style, _ = batch
    n = np.asarray([CFG.max_n_phonemes // 2, CFG.max_n_phonemes, 3, 9])
    ref = synthesize(pt, cfg, src, pun, style, n, device="cpu")
    unmasked = synthesize(pt, CFG, src, pun, style, n, device="cpu")
    assert not np.allclose(ref.wav.numpy(), unmasked.wav.numpy(), atol=1e-6)
    wav, mel_len = tpar.PipelinedTTS(pt, cfg, "cpu", "cpu").run([(src, pun, style, n)])[0]
    np.testing.assert_array_equal(mel_len, ref.mel_len.numpy())
    np.testing.assert_allclose(wav, ref.wav.numpy(), **STREAM)
    sp, fn = tpar.make_sharded_synthesize(cfg, cpu_mesh(2, 2), pt)
    tp = fn(sp, src, pun, style, n)
    np.testing.assert_array_equal(tp.mel_len.numpy(), ref.mel_len.numpy())
    np.testing.assert_allclose(tp.wav.numpy(), ref.wav.numpy(), **TP)


def test_dryrun_multichip_on_cpu(capsys):
    """The dry run over 4 devices (the CPU repeated) prints one OK line per
    regime, as the JAX package's does (MULTICHIP_r05.json), each regime
    held against the single-device pipeline inside it."""
    from zerovox_tpu_torch.tools.dryrun_multichip import main
    assert main(["4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    for regime in ("inference[pure-DP]", "inference[TP2+time-sharded]",
                   "inference[PP 2-stage]", "inference[time-SP x4]",
                   "serving-engine[pure-DP]", "serving-engine[TP2]"):
        assert any(line.startswith(f"dryrun_multichip {regime} OK") for line in out), regime
    assert out[-1].startswith("dryrun_multichip OK: 4 devices (1 distinct: cpu)")


def test_tp_products_copy_inputs_to_each_shards_device(monkeypatch):
    """The row- and column-parallel products copy each input to its shard's
    device before the product, and the partial sums to the lead: with
    shards on another device than the inputs (meta here), every product is
    called with its operands on one device (a card refuses anything else)."""
    from zerovox_tpu_torch.parallel import tp
    meta = torch.device("meta")
    calls = []

    def conv1d(x, w, b=None, padding=0, dilation=1):
        calls.append((x.device, w.device))
        assert x.device == w.device and (b is None or b.device == w.device)
        return torch.zeros(x.shape[0], x.shape[1], w.shape[0], device=w.device, dtype=x.dtype)

    monkeypatch.setattr(tp, "conv1d", conv1d)
    w = tp.Shards((torch.zeros(4, 3, 1, device=meta), torch.zeros(4, 5, 1, device=meta)), 1)
    xs = [torch.zeros(2, 7, 3), torch.zeros(2, 7, 5)]            # on the CPU
    y = tp._row(tp._conv(), xs, w, torch.zeros(4, device=meta), meta)
    assert y.device == meta and y.shape == (2, 7, 4)
    wc = tp.Shards((torch.zeros(3, 8, 1, device=meta), torch.zeros(5, 8, 1, device=meta)), 0)
    outs = tp._col(tp._conv(), torch.zeros(2, 7, 8), wc, None)
    assert [o.device for o in outs] == [meta, meta] and [o.shape[-1] for o in outs] == [3, 5]
    assert calls == [(meta, meta)] * 4
    assert [v.device for v in tp._split_like(torch.zeros(8), wc)] == [meta, meta]
