"""The port's training CLI (zerovox_tpu_torch.training.cli) against the JAX
package's on the CPU, at TINY: datasets, argument checks, and a run with a
resume whose exported GGUF matches the JAX CLI's own run.

The JAX CLI runs in a process of its own with one device (--mesh 1,1):
tests/conftest.py gives this process 8 virtual devices, and the JAX CLI's
--mesh must cover every device.  The exports are held to AdamW's tolerance, 2 * lr per
optimizer step (Adam turns float noise in near-zero gradients into
lr-sized steps), and conv kernels, stored as float16, to half a float16 ulp
beyond it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import zerovox_tpu.training.cli as jcli
from zerovox_tpu.config import TINY_CONFIG as J_TINY

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG as CFG
from zerovox_tpu_torch.io.gguf import GGUFReader
from zerovox_tpu_torch.training import cli as tcli
from zerovox_tpu_torch.training.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3


def test_synthetic_dataset_matches_jax():
    for got, want in zip(tcli.synthetic_dataset(CFG, 5, seed=4),
                         jcli.synthetic_dataset(J_TINY, 5, seed=4)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _raises_same(tmp_path, name, arrays):
    path = str(tmp_path / name)
    if arrays is None:
        Path(path).write_bytes(b"not an npz")
    else:
        np.savez(path, **arrays)
    with pytest.raises(SystemExit) as je:
        jcli.load_dataset_npz(path, J_TINY)
    with pytest.raises(SystemExit) as te:
        tcli.load_dataset_npz(path, CFG)
    return str(te.value), str(je.value)


@pytest.mark.parametrize("fault", ["shape", "missing", "unreadable"])
def test_dataset_npz_validation_matches_jax(tmp_path, fault):
    data = tcli.synthetic_dataset(CFG, 4, seed=1)._asdict()
    if fault == "shape":
        data["mel_target"] = data["mel_target"][:, :-1]
    elif fault == "missing":
        del data["durations"]
    got, want = _raises_same(tmp_path, "d.npz", None if fault == "unreadable" else data)
    if fault == "unreadable":        # the reader's own message may name another path form
        assert got.startswith("cannot read dataset") and want.startswith("cannot read dataset")
    else:
        assert got == want
        assert ("mel_target" if fault == "shape" else "durations") in got


def test_dataset_npz_roundtrip(tmp_path):
    data = tcli.synthetic_dataset(CFG, 4, seed=2)
    path = str(tmp_path / "d.npz")
    np.savez(path, **data._asdict())
    for got, want in zip(tcli.load_dataset_npz(path, CFG), data):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra,match", [
    (["--accum", "0"], "--accum must be >= 1"),
    (["--warmup-steps", "-1"], "--warmup-steps must be >= 0"),
    (["--accum", "3"], "must divide by --accum 3"),
    (["--epochs", "0"], None)])
def test_cli_rejects_bad_arguments(extra, match, capsys):
    args = ["--synthetic", "4", "--tiny", "--batch-size", "4", "--device", "cpu"] + extra
    with pytest.raises(SystemExit) as e:
        tcli.main(args)
    if match is None:                   # argparse's error: exit code 2
        assert e.value.code == 2 and "--epochs must be >= 1" in capsys.readouterr().err
    else:
        assert match in str(e.value)


def _jax_cli(args, tmp_path):
    """Run the JAX training CLI in a fresh process with one CPU device."""
    code = ("import json, sys, jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "from zerovox_tpu.training.cli import main\n"
            "assert main(json.loads(sys.argv[1])) == 0\n")
    env = {**os.environ, "XLA_FLAGS": "", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code, json.dumps(args)],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stderr


def _arrays(path):
    with GGUFReader(str(path)) as r:
        return r.load_all(as_float32=True)


def test_cli_run_resume_export_matches_jax_cli(tmp_path, capsys):
    """8 datums, batch 4, val 0.25, --accum 2: one optimizer step on 2
    microbatches and one validation batch per epoch, the same batch every
    epoch (one train batch: fit reshuffles nothing after the first
    shuffle).  The port's CLI run twice, the second resuming from step 1,
    ends where the JAX CLI's 2-epoch run ends, to AdamW's tolerance.
    Without the STFT loss, which triples the JAX CLI's compile time: the
    STFT route is held against JAX by tests/test_torch_training.py, and
    test_cli_trains_with_the_stft_at_tiny runs it through this CLI."""
    base = ["--synthetic", "8", "--tiny", "--batch-size", "4", "--val-split", "0.25",
            "--accum", "2", "--seed", "3", "--lr", str(LR), "--no-stft"]
    jlog = _jax_cli(base + ["--epochs", "2", "--mesh", "1,1",
                            "--export", str(tmp_path / "j.gguf")], tmp_path)
    assert "train: 2 total steps" in jlog

    ck = tmp_path / "tck"
    for i in (1, 2):
        assert tcli.main(base + ["--epochs", "1", "--device", "cpu", "--checkpoint-dir", str(ck),
                                 "--checkpoint-every", "1",
                                 "--export", str(tmp_path / "t.gguf")]) == 0
        with CheckpointManager(str(ck)) as mgr:
            assert mgr.latest_step() == i
        err = capsys.readouterr().err
        assert ("resumed from step 1" in err) == (i == 2)
        assert f"train: {i} total steps" in err

    want, got = _arrays(tmp_path / "j.gguf"), _arrays(tmp_path / "t.gguf")
    assert got.keys() == want.keys()
    for name, a in want.items():
        np.testing.assert_allclose(got[name], a, rtol=2.0 ** -11 if a.ndim == 3 else 0,
                                   atol=2 * LR * 2, err_msg=name)
    start = _arrays_of_init()
    assert max(np.abs(got[n] - a).max() for n, a in start.items()) > LR
    cfg, _ = tparams.load_params(str(tmp_path / "t.gguf"), device="cpu")
    assert cfg == CFG
    assert sorted(p.name for p in ck.iterdir()) == ["step_1.pt", "step_2.pt"]


def test_cli_trains_with_the_stft_at_tiny(tmp_path, capsys):
    """The small-geometry STFT resolutions (the default ones need a longer
    waveform than TINY's 3840 samples) and a cosine schedule with warmup."""
    assert tcli.main(["--synthetic", "4", "--tiny", "--batch-size", "2", "--device", "cpu",
                      "--lr-schedule", "cosine", "--warmup-steps", "1",
                      "--export", str(tmp_path / "m.gguf")]) == 0
    err = capsys.readouterr().err
    assert "stft=True" in err and "train: 2 total steps" in err


def _arrays_of_init():
    return tparams.params_to_arrays(tparams.init_params(CFG, seed=3, device="cpu"), CFG)
