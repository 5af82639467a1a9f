"""Every examples_torch/ script runs green with --device cpu (TINY), and
what each writes is held against the JAX package on the same inputs.

The scripts run in subprocesses, all started at once, each with its own
output directory and timeout.  The JAX side runs in this process from the
same seed-0 parameters (init_params draws bitwise the same weights in
both packages) and the same demo_utterance:
  01  example01.wav against zerovox_tpu.jit_synthesize, within 1 LSB of PCM16;
  02  example02.wav against the JAX StreamingSynthesizer at chunk 16 /
      overlap 4, within 1 LSB;
  03  example03.wav (the daemon's ?trim=0 answer) against the JAX one-shot
      full buffer, within 1 LSB;
  04  the exported GGUF loaded by both packages' load_params: the same cfg
      and bitwise-equal arrays;
  05  exit 0 with its in-script gates (DP row 0 at atol 5e-5, TP at the
      JAX gate or every moved bucket explained);
  06  example06.gguf byte-equal to zerovox_tpu.save_params of the same
      parameters, and the skip printed (no reference tree here); the same
      byte equality at one production-geometry init_params.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import zerovox_tpu.params as jparams
from zerovox_tpu import jit_synthesize
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.config import ZeroVoxConfig as JConfig
from zerovox_tpu.models.streaming import StreamingSynthesizer as JStreaming

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
from zerovox_tpu_torch.io.wav import float_to_pcm16, read_wav

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
SCRIPTS = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py") and f[0].isdigit())
TIMEOUT = 300
LSB = 1


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """script -> (subprocess, its output directory), every script started
    at once on the CPU; finished() waits for one."""
    env = {**os.environ, "PYTHONPATH": "", "OMP_NUM_THREADS": "2"}
    procs = {}
    for script in SCRIPTS:
        out = tmp_path_factory.mktemp(script[:2])
        procs[script] = (subprocess.Popen(
            [sys.executable, str(EXAMPLES / script), "--device", "cpu", "--out-dir", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=EXAMPLES, env=env),
            out)
    yield procs
    for p, _ in procs.values():
        if p.returncode is None:          # no test waited for it
            p.kill()
            p.communicate()


def finished(runs, script):
    """(stdout, output directory) of `script`, which must exit 0 within TIMEOUT."""
    p, out = runs[script]
    try:
        stdout, stderr = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        pytest.fail(f"{script} ran past {TIMEOUT} s")
    assert p.returncode == 0, f"{script} failed:\n{stdout}\n{stderr}"
    assert stdout.strip(), f"{script} printed nothing"
    return stdout, out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's seed-0 TINY parameters, the demo utterance and its
    one-shot result."""
    params = jparams.init_params(J_TINY, seed=0)
    src, pun, style = _load(ROOT / "examples" / "_common.py", "_jax_common").demo_utterance(J_TINY)
    res = jit_synthesize(params, J_TINY)(params, src, pun, style)
    return params, (src, pun, style), res


def pcm_of(path) -> np.ndarray:
    wav, rate = read_wav(str(path))
    assert rate == TINY_CONFIG.sampling_rate
    return np.round(wav * 32767.0).astype(np.int32)


def hold_lsb(got: np.ndarray, want_float: np.ndarray, what: str):
    want = float_to_pcm16(want_float).astype(np.int32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert len(got) > 0 and np.abs(got).max() > 0, what
    d = np.abs(got - want).max()
    assert d <= LSB, f"{what}: {d} LSB from the JAX package"


def test_demo_utterance_is_the_jax_examples():
    port = _load(EXAMPLES / "_common.py", "_torch_common")
    jax_ = _load(ROOT / "examples" / "_common.py", "_jax_common")
    for seed, batch in ((0, 1), (2, 3)):
        for a, b in zip(port.demo_utterance(TINY_CONFIG, seed, batch),
                        jax_.demo_utterance(J_TINY, seed, batch)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_01_synthesize(runs, jax_side):
    stdout, out = finished(runs, "01_synthesize.py")
    _, _, res = jax_side
    wav = np.asarray(res.wav)[0]
    mel_len = int(np.asarray(res.mel_len)[0])
    assert f"predicted mel_len={mel_len} frames" in stdout
    hold_lsb(pcm_of(out / "example01.wav"), wav[:mel_len * J_TINY.hop_size] if mel_len else wav,
             "01")


def test_02_stream(runs, jax_side):
    _, out = finished(runs, "02_stream.py")
    params, (src, pun, style), _ = jax_side
    s = JStreaming(params, J_TINY, chunk_frames=16, overlap=4)
    wav = np.concatenate([np.asarray(c) for c in s.stream(src, pun, style)], axis=1)[0]
    hold_lsb(pcm_of(out / "example02.wav"), wav, "02")


def test_03_serve_client(runs, jax_side):
    stdout, out = finished(runs, "03_serve_client.py")
    _, _, res = jax_side
    hold_lsb(pcm_of(out / "example03.wav"), np.asarray(res.wav)[0], "03")
    for line in ("/synthesize (binary body) -> identical", "/batch     -> 2 wavs",
                 "/stream    -> first chunk", "metrics:"):
        assert line in stdout


def test_04_train_export(runs):
    stdout, out = finished(runs, "04_train_export.py")
    assert "reloaded checkpoint synthesizes" in stdout
    path = str(out / "example04.gguf")
    cfg_j, pj = jparams.load_params(path)
    cfg_t, pt = tparams.load_params(path, device="cpu")
    assert cfg_t.to_json() == cfg_j.to_json() == TINY_CONFIG.to_json()
    a, b = jparams.params_to_arrays(pj, cfg_j), tparams.params_to_arrays(pt, cfg_t)
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # the export holds the trained weights, not the seed-0 ones it started from
    assert any(not np.array_equal(a[n], v) for n, v in
               jparams.params_to_arrays(jparams.init_params(J_TINY, seed=0), J_TINY).items())


def test_05_sharded_serving(runs):
    stdout, _ = finished(runs, "05_sharded_serving.py")
    assert "mesh {'data': 8, 'model': 1}" in stdout
    assert "DP row 0 against the single-device engine: 1 utterance(s)" in stdout
    assert "TP {'data': 2, 'model': 4} B=1 dispatch" in stdout
    assert "TP wav against the single-device engine: 1 utterance(s)" in stdout


def test_06_verify_checkpoint(runs, jax_side, tmp_path):
    stdout, out = finished(runs, "06_verify_checkpoint.py")
    assert "verify: SKIPPED" in stdout
    assert "point ZEROVOX_REF at the reference checkout" in stdout
    path = str(tmp_path / "jax.gguf")
    jparams.save_params(path, jax_side[0], J_TINY)
    assert (out / "example06.gguf").read_bytes() == Path(path).read_bytes()


def test_save_params_casts_conv_kernels_as_the_jax_writer_at_production(tmp_path):
    """save_params casts the named conv kernels (conv_kernel_names) to f16:
    at production geometry the file is the JAX writer's, byte for byte, and
    the names are the 3-d tensors of the tree."""
    cfg = ZeroVoxConfig()
    pt = tparams.init_params(cfg, seed=0, device="cpu")
    arrays = tparams.params_to_arrays(pt, cfg)
    assert tparams.conv_kernel_names(cfg) == {n for n, a in arrays.items() if a.ndim == 3}
    p_t, p_j = tmp_path / "torch.gguf", tmp_path / "jax.gguf"
    tparams.save_params(str(p_t), pt, cfg)
    del pt, arrays
    jparams.save_params(str(p_j), jparams.init_params(JConfig(), seed=0), JConfig())
    assert p_t.read_bytes() == p_j.read_bytes()


def test_examples_list_is_complete():
    # the README table and the directory stay in sync
    readme = (EXAMPLES / "README.md").read_text()
    assert len(SCRIPTS) == 6
    for script in SCRIPTS:
        assert script in readme, f"{script} missing from examples_torch/README.md"
