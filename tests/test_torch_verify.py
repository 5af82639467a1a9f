"""The port's `cli --verify` (zerovox_tpu_torch.utils.verify) against the JAX
tool (zerovox_tpu.utils.verify), on the CPU.

The reference C++ tree is not here, so both tools are held against a
stand-in reference patched into their get_stage_harness and RefStages: the
JAX package's own stages under f16_staging (encode -> durations_from_log ->
length_regulate, decode, vocode), on the checkpoint both tools load.  The
JAX tool then compares the JAX stages with themselves, and the port's report
must match its report: the same boundaries in the same order, the same ok
flags, notes and tolerances, and each max|diff| within its tolerance.  The
"unavailable" branch (exit 2) and the worker's wire protocol run for real.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import zerovox_tpu.refharness.build as jbuild
import zerovox_tpu.refharness.stage_proc as jstage
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.models import fs2_encoder as j_enc
from zerovox_tpu.models import hifigan as j_voc
from zerovox_tpu.models import styletts_decoder as j_dec
from zerovox_tpu.ops.conv import f16_staging as j_staging
from zerovox_tpu.ops.length_regulator import durations_from_log, length_regulate
from zerovox_tpu.params import load_params as j_load
from zerovox_tpu.utils import verify as jverify

import zerovox_tpu_torch.refharness.build as tbuild
import zerovox_tpu_torch.refharness.stage_proc as tstage
from zerovox_tpu_torch import cli as tcli
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.models import styletts_decoder
from zerovox_tpu_torch.utils import verify as tverify

from oracles.synthetic import build_synthetic_gguf

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_verify") / "tiny.gguf")
    build_synthetic_gguf(path, TINY_CONFIG, seed=11, duration_bias=1.5)
    return path


class _StandIn:
    """InprocStages' interface over the JAX package's staged stages, jitted
    once (traced under the staging) and memoized per input."""

    _fns, _memo = {}, {}

    def __init__(self, lib, gguf_path, cfg, *args, **kwargs):
        self.key = gguf_path
        if gguf_path not in self._fns:
            jcfg, p = j_load(gguf_path)
            T = jcfg.max_seq_len

            def encoder(s, u, y):
                feat, log_dur = j_enc.encode(p, jcfg, s, u, y)
                hidden, total = length_regulate(feat, durations_from_log(log_dur, T), T)
                return hidden, total, log_dur

            self._fns[gguf_path] = dict(
                encoder=jax.jit(encoder),
                decoder=jax.jit(lambda h, y: j_dec.decode(p, jcfg, h, y)),
                vocoder=jax.jit(lambda m: j_voc.vocode(p, jcfg, m)))

    def _run(self, name, *arrays):
        key = (self.key, name) + tuple(np.asarray(a).tobytes() for a in arrays)
        if key not in self._memo:
            with j_staging():
                self._memo[key] = self._fns[self.key][name](
                    *(jnp.asarray(np.asarray(a)[None]) for a in arrays))
        return self._memo[key]

    def encoder(self, src, puncts, style, num_phonemes):
        assert num_phonemes == len(src)
        hidden, total, _ = self._run("encoder", src, puncts, style)
        return np.asarray(hidden[0], np.float32), int(total[0])

    def log_duration(self, src, puncts, style):
        return np.asarray(self._run("encoder", src, puncts, style)[2][0])

    def decoder(self, hidden, style):
        return np.asarray(self._run("decoder", hidden, style)[0], np.float32)

    def vocoder(self, mel):
        return np.asarray(self._run("vocoder", mel)[0], np.float32)

    def free(self):
        pass


def _stand_in(monkeypatch, stages=_StandIn):
    for build, stage in ((jbuild, jstage), (tbuild, tstage)):
        monkeypatch.setattr(build, "get_stage_harness", lambda *a, **k: (object(), ""))
        monkeypatch.setattr(stage, "RefStages", stages)


@pytest.fixture(scope="module")
def jax_report(tiny_gguf):
    """The JAX tool's report on the fixture (run once: it compiles its
    stages at every call)."""
    mp = pytest.MonkeyPatch()
    try:
        _stand_in(mp)
        return jverify.verify_checkpoint(tiny_gguf, log=lambda m: None)
    finally:
        mp.undo()


def test_report_matches_the_jax_tool(tiny_gguf, jax_report, monkeypatch):
    _stand_in(monkeypatch)
    # the fixture's durations have a rounding margin (tests/test_ggml_stage_diff.py)
    src, pun, style = tverify.probe_utterance(TINY_CONFIG, seed=7)
    d = np.exp(_StandIn(None, tiny_gguf, None).log_duration(src, pun, style)
               .astype(np.float64)) - 1.0 + 0.5
    assert np.abs(d - np.round(d)).min() > 1e-3
    got = tverify.verify_checkpoint(tiny_gguf, log=lambda m: None, device="cpu")
    print(got.summary())
    assert jax_report.ok and got.ok and got.skipped_reason is None
    assert [(b.name, b.ok, b.note, b.tol) for b in got.boundaries] == \
        [(b.name, b.ok, b.note, b.tol) for b in jax_report.boundaries]
    assert all(b.max_abs <= b.tol for b in got.boundaries)
    assert "mel_len" in got.boundaries[0].note and "masked" not in got.boundaries[0].note
    assert got.summary().splitlines()[-1] == jax_report.summary().splitlines()[-1]


def test_cli_verify_on_the_cpu_exits_0(tiny_gguf, monkeypatch, capsys):
    _stand_in(monkeypatch)
    assert tcli.main(["--model", tiny_gguf, "--verify", "--device", "cpu"]) == 0
    assert "verify: PASS — all eval() boundaries match" in capsys.readouterr().out


def test_biased_decoder_fails_only_the_decoder(tiny_gguf, monkeypatch):
    """A decoder biased by +0.05 on our side trips exactly the decoder
    boundary, as in the JAX tool's test, and the CLI exits 1."""
    _stand_in(monkeypatch)
    real = styletts_decoder.decode
    monkeypatch.setattr(styletts_decoder, "decode", lambda *a, **k: real(*a, **k) + 0.05)
    report = tverify.verify_checkpoint(tiny_gguf, log=lambda m: None, device="cpu")
    assert [b.ok for b in report.boundaries] == [True, False, True] and not report.ok
    assert report.summary().splitlines()[-1] == "verify: FAIL"
    assert tcli.main(["--model", tiny_gguf, "--verify", "--device", "cpu"]) == 1


def test_unavailable_reference_exits_2_with_the_jax_reason(tiny_gguf, tmp_path, monkeypatch,
                                                           capsys):
    """ZEROVOX_REF pointed at an empty directory: both CLIs print the same
    SKIPPED line and exit 2 (the JAX CLI in a process of its own: its build
    module reads ZEROVOX_REF when it is imported)."""
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("ZEROVOX_REF", str(empty))
    assert tcli.main(["--model", tiny_gguf, "--verify", "--device", "cpu"]) == 2
    line = capsys.readouterr().out.strip()
    assert line == ("verify: SKIPPED — reference harness unavailable: reference ggml tree "
                    "not available")
    jax_cli = subprocess.run(
        [sys.executable, "-c", "import sys; from zerovox_tpu.cli import main; "
         "sys.exit(main(sys.argv[1:]))", "--model", tiny_gguf, "--verify"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"})
    assert jax_cli.returncode == 2, jax_cli.stderr
    assert jax_cli.stdout.strip() == line


class _Stop(Exception):
    pass


def test_verify_seed_draws_the_jax_probe(tiny_gguf, monkeypatch):
    """--verify-seed 3: the port sends the reference the probe the JAX tool
    sends it (both stopped at the first reference call)."""
    drawn = {}

    def recorder(tool):
        class Recorder(_StandIn):
            def encoder(self, *args):
                drawn[tool] = args
                raise _Stop
        return Recorder

    for tool, (build, stage) in (("jax", (jbuild, jstage)), ("port", (tbuild, tstage))):
        monkeypatch.setattr(build, "get_stage_harness", lambda *a, **k: (object(), ""))
        monkeypatch.setattr(stage, "RefStages", recorder(tool))
    with pytest.raises(_Stop):
        jverify.verify_checkpoint(tiny_gguf, seed=3, log=lambda m: None)
    with pytest.raises(_Stop):
        tcli.main(["--model", tiny_gguf, "--verify", "--verify-seed", "3", "--device", "cpu"])
    assert drawn["jax"][3] == drawn["port"][3] == TINY_CONFIG.max_n_phonemes
    for a, b in zip(drawn["jax"][:3], drawn["port"][:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    seven = tverify.probe_utterance(TINY_CONFIG, seed=7)
    assert not np.array_equal(seven[0], drawn["port"][0])


def test_worker_framing_and_imports(tmp_path):
    """The wire protocol round-trips (a large array, an error frame, a
    closed pipe), and the worker process, started as RefStages starts it,
    answers over it, imports neither torch nor jax nor either package, and
    exits on "exit"."""
    buf = io.BytesIO()
    msg = ("ok", (np.arange(300_000, dtype=np.float32), 17))
    tstage._send(buf, msg)
    tstage._send(buf, ("err", "RuntimeError: boom"))
    buf.seek(0)
    status, (arr, n) = tstage._recv(buf)
    assert status == "ok" and n == 17 and np.array_equal(arr, msg[1][0])
    assert tstage._recv(buf) == ("err", "RuntimeError: boom")
    with pytest.raises(EOFError):
        tstage._recv(buf)

    empty = tmp_path / "empty"
    empty.mkdir()
    env = tstage.worker_env(tmp_path / "build")
    env.update(ZEROVOX_REF=str(empty), PYTHONPROFILEIMPORTTIME="1")
    proc = subprocess.Popen([sys.executable, tstage.__file__], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    try:
        assert tstage._recv(proc.stdout) == ("err", "reference ggml tree not available")
        tstage._send(proc.stdin, ("vocoder", (np.zeros(4, np.float32),)))
        status, reason = tstage._recv(proc.stdout)        # no model loaded
        assert status == "err" and reason.startswith("AttributeError")
        tstage._send(proc.stdin, ("exit", ()))
        _, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0
    imported = {line.split("|")[-1].strip().split(".")[0]
                for line in err.decode().splitlines() if line.startswith("import time:")}
    assert "numpy" in imported
    assert not imported & {"torch", "jax", "jaxlib", "zerovox_tpu", "zerovox_tpu_torch"}
    assert env["ZEROVOX_REFHARNESS_BUILD"] == str(tmp_path / "build")


def test_a_worker_that_dies_is_an_error(tiny_gguf, monkeypatch):
    """A worker that answers its first frame and then exits: RefStages, the
    tool and the CLI raise; nothing reports a skip or a verdict."""
    monkeypatch.setattr(tbuild, "get_stage_harness", lambda *a, **k: (object(), ""))
    script = ("import pickle, struct, sys; d = pickle.dumps(('ok', None)); "
              "sys.stdout.buffer.write(struct.pack('<Q', len(d)) + d)")
    monkeypatch.setattr(tstage, "start_worker", lambda build=None: subprocess.Popen(
        [sys.executable, "-c", script], stdin=subprocess.PIPE, stdout=subprocess.PIPE))
    with pytest.raises((EOFError, BrokenPipeError)):
        tverify.verify_checkpoint(tiny_gguf, log=lambda m: None, device="cpu")
    with pytest.raises((EOFError, BrokenPipeError)):
        tcli.main(["--model", tiny_gguf, "--verify", "--device", "cpu"])


def test_reference_root_and_build_directory(tmp_path, monkeypatch):
    """$ZEROVOX_REF is read at each call (default: reference/ in the
    checkout); the builds go to the argument, else $ZEROVOX_REFHARNESS_BUILD,
    else build/zerovox_tpu_torch/refharness; an absent tree is reported, not
    raised, and the harness sources ship beside build.py."""
    monkeypatch.delenv("ZEROVOX_REF", raising=False)
    monkeypatch.delenv(tbuild.BUILD_ENV, raising=False)
    assert tbuild.ref_root() == ROOT / "reference"
    assert tbuild.build_root() == ROOT / "build" / "zerovox_tpu_torch" / "refharness"
    monkeypatch.setenv("ZEROVOX_REF", str(tmp_path))
    monkeypatch.setenv(tbuild.BUILD_ENV, str(tmp_path / "b"))
    assert tbuild.ref_root() == tmp_path and tbuild.build_root() == tmp_path / "b"
    assert tbuild.build_root(tmp_path / "c") == tmp_path / "c"
    assert tbuild.get_stage_harness() == (None, "reference ggml tree not available")
    assert tbuild.get_harness(tmp_path / "c") == (None, "reference ggml tree not available")
    for src in (tbuild.HARNESS_C, tbuild.STAGE_CPP, tbuild.ZEROMALLOC_C):
        assert src.is_file() and src.parent == Path(tbuild.__file__).resolve().parent
