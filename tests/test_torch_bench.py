"""The port's bench, bench_daemon and measure_daemon_attrib
(zerovox_tpu_torch/tools/) against the JAX scripts they port: the same
inputs, utterances and shifted weights, the timed computation against the
JAX package's synthesize, and every key the JAX scripts write in the tools'
JSON lines (read from the JAX sources' AST).  TINY geometry on the CPU; the
daemon tools run in subprocesses, as on the card."""

import ast
import importlib.util
import io
import json
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.config import ZeroVoxConfig as JConfig
from zerovox_tpu.models.pipeline import jit_synthesize as j_jit_synthesize

import chip_smoke
from zerovox_tpu_torch import params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
from zerovox_tpu_torch.models.pipeline import load_model
from zerovox_tpu_torch.tools import bench, bench_daemon, measure

ROOT = Path(__file__).resolve().parents[1]
WAV = dict(atol=1e-3, rtol=1e-3)          # docs/ARCHITECTURE.md §10


def _main(path):
    tree = ast.parse(Path(path).read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _run(nodes, ns):
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), "<jax script>", "exec"), ns)
    return ns


def json_keys(path):
    """The keys a JAX script's `out` line can hold: the `out = {...}`
    literal's and every `out["key"] = ...`."""
    keys = []
    for node in ast.walk(_main(path)):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "out" and isinstance(node.value, ast.Dict):
            keys += [(k.lineno, k.col_offset, k.value) for k in node.value.keys]
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and getattr(node.targets[0].value, "id", None) == "out":
            keys.append((node.lineno, 0, node.targets[0].slice.value))
    return [k for *_, k in sorted(keys)]


def bench_py_inputs(cfg):
    """bench.py's B=1 then B=8 draws (its main's statements, run as they are)."""
    want = {"src", "pun", "style", "B8", "src8", "pun8", "sty8"}
    nodes = sorted((n for n in ast.walk(_main(ROOT / "bench.py")) if isinstance(n, ast.Assign)
                    and isinstance(n.targets[0], ast.Name) and n.targets[0].id in want),
                   key=lambda n: n.lineno)
    ns = _run(nodes, {"rng": np.random.default_rng(0), "B": 1, "cfg": cfg, "jnp": jnp,
                      "np": np})
    return [tuple(np.asarray(ns[k]) for k in ks)
            for ks in (("src", "pun", "style"), ("src8", "pun8", "sty8"))]


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "production"])
def test_bench_inputs_equal_bench_py(tiny):
    jcfg = J_TINY if tiny else JConfig()
    rng = np.random.default_rng(0)
    cfg = TINY_CONFIG if tiny else ZeroVoxConfig()
    ours = [measure.draw_inputs(cfg, 1, rng), measure.draw_inputs(cfg, 8, rng)]
    for got, want in zip(ours, bench_py_inputs(jcfg)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _jax_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "production"])
def test_utterances_equal_the_jax_script(tiny):
    jax_script = _jax_module(ROOT / "scripts" / "bench_daemon.py", "jax_bench_daemon")
    jcfg, cfg = (J_TINY, TINY_CONFIG) if tiny else (JConfig(), ZeroVoxConfig())
    for seed in [*range(4), *range(100, 108)]:
        assert bench_daemon._utterance(cfg, seed) == jax_script._utterance(jcfg, seed)


def _shift_statements(script):
    """The statements of a JAX daemon script that make its served weights
    from init_params (the +1.5 shift of the duration predictor's bias)."""
    main = _main(ROOT / "scripts" / script)
    if script == "bench_daemon.py":
        branch = next(n for n in main.body if isinstance(n, ast.If)
                      and ast.unparse(n.test) == "args.model")
        return branch.orelse
    start = next(i for i, n in enumerate(main.body) if isinstance(n, ast.Assign)
                 and ast.unparse(n.targets[0]) == "cfg")
    stop = next(i for i, n in enumerate(main.body) if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == "rng")
    return main.body[start:stop]


@pytest.mark.parametrize("script", ["bench_daemon.py", "measure_daemon_attrib.py"])
def test_shifted_params_equal_the_jax_scripts(script):
    ns = _run(_shift_statements(script), {
        "args": types.SimpleNamespace(tiny=True), "TINY_CONFIG": J_TINY,
        "ZeroVoxConfig": JConfig, "init_params": jparams.init_params})
    want = jparams.params_to_arrays(ns["params"], J_TINY)
    got = tparams.params_to_arrays(
        measure.shift_duration(tparams.init_params(TINY_CONFIG, seed=0, device="cpu")),
        TINY_CONFIG)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)
    lin_b = tparams.gguf_name_map(TINY_CONFIG)[("encoder", "duration_predictor", "lin_b")][0]
    np.testing.assert_allclose(got[lin_b], 1.2 + 1.5, rtol=1e-6)   # init_params' 1.2, shifted


@pytest.mark.parametrize("B", [1, 8])
def test_timed_run_matches_jax_synthesize(B):
    """The bench's timed computation at TINY in f32 on the CPU gives the JAX
    package's synthesize wav on the same inputs and weights."""
    cfg = measure.model_config(True, "float32")
    rng = np.random.default_rng(0)
    inputs = measure.draw_inputs(cfg, 1, rng)
    if B == 8:
        inputs = measure.draw_inputs(cfg, 8, rng)
    pj = jparams.init_params(J_TINY, seed=0)
    model = load_model(tparams.init_params(cfg, seed=0, device="cpu"), cfg,
                       measure.start("cpu"))
    got = bench.timed_run(model, cfg, *measure.on_device(model.device, *inputs))()
    want = j_jit_synthesize(pj, J_TINY)(pj, *(jnp.asarray(a) for a in inputs)).wav
    assert got.shape == (B, cfg.max_seq_len * cfg.hop_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WAV)


def _line(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# the tools run in subprocesses, all started with this file's first test
_RUNS = {
    "bench": ["--tiny", "--device", "cpu", "--iters", "2", "--warmup", "0"],
    "bench_daemon": ["--tiny", "--device", "cpu", "--reps", "2", "--load", "2",
                     "--stream-load", "2", "--batch-window-ms", "5"],
    "measure_daemon_attrib": ["--tiny", "--device", "cpu", "--reps", "3"],
}


@pytest.fixture(scope="module", autouse=True)
def tool_line():
    # one thread each: the suite's other workers share the machine's cores
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"zerovox_tpu_torch.tools.{name}", *argv], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, argv in _RUNS.items()}

    def line(name):
        """The tool's JSON line, once its run (120 s at most) has ended."""
        out, err = procs[name].communicate(timeout=120)
        assert procs[name].returncode == 0, err[-3000:]
        assert f"{name}: mrf_launches " in err
        return json.loads(out.strip().splitlines()[-1])

    try:
        yield line
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


def test_bench_line_holds_bench_py_keys(tool_line):
    """The default flags (B=1, the B=8 leg, TTFA, the daemon leg in its
    subprocess): every key bench.py writes, then card and single_ms."""
    line = tool_line("bench")
    keys = json_keys(ROOT / "bench.py")
    assert len(keys) == 11 and list(line) == keys + ["card", "single_ms"]
    assert line["card"] == "cpu" and line["metric"] == "rtf_wall_per_audio_sec"
    assert all(line[k] > 0 for k in keys if k not in ("metric", "unit"))
    assert chip_smoke.TOOL_KEYS["bench"] == keys + ["card", "single_ms"]


def test_bench_f32_line():
    """--f32 runs no B=8 and no daemon leg, as bench.py."""
    line = _line(bench.main, ["--tiny", "--device", "cpu", "--f32", "--iters", "2",
                              "--warmup", "0", "--no-ttfa"])
    assert list(line) == chip_smoke.TOOL_KEYS["bench --f32"][:6] + ["card", "single_ms"]
    assert set(chip_smoke.TOOL_KEYS["bench --f32"]) <= set(json_keys(ROOT / "bench.py")) | {
        "card", "single_ms"}


@pytest.mark.parametrize("argv", [["--fuse-a"], ["--iters", "1"]])
def test_bench_refuses(argv, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    assert ("vocoder_fuse_a_upsample" if "--fuse-a" in argv else "--iters") \
        in capsys.readouterr().err


def test_bench_daemon_line_holds_the_jax_scripts_keys(tool_line):
    line = tool_line("bench_daemon")
    keys = json_keys(ROOT / "scripts" / "bench_daemon.py")
    assert len(keys) == 24 and set(keys) <= set(line), set(keys) - set(line)
    assert line["stall_dropped_reps"] == line["load_failures"] == 0
    assert line["stream_load_failures"] == 0 and line["reps"] == 2
    assert line["load_completed"] == 2 * 3 and line["stream_load_completed"] == 2 * 2
    assert line["load_batcher"]["requests"] >= 6
    window0 = [k for k in keys if k != "load_batcher"]
    assert chip_smoke.TOOL_KEYS["bench_daemon window 0"] == window0
    assert chip_smoke.TOOL_KEYS["bench_daemon window 5"] == window0 + ["load_batcher"]


def test_measure_daemon_attrib_line_holds_the_jax_scripts_keys(tool_line):
    line = tool_line("measure_daemon_attrib")
    keys = json_keys(ROOT / "scripts" / "measure_daemon_attrib.py")
    assert list(line) == keys == chip_smoke.TOOL_KEYS["measure_daemon_attrib"]
    assert line["requests"] == 6 and line["engine_ms"] > 0


def test_load_counts_a_failed_request_and_goes_on():
    """Under --load a request that fails is counted in load_failures, not
    retried and not credited; the client opens a new connection."""
    calls = []

    class Conn:
        def request(self, *a):
            calls.append(a[1])
            if len(calls) == 2:
                raise ConnectionResetError("reset by peer")

        def getresponse(self):
            return types.SimpleNamespace(status=200, read=lambda *a: b"")

        def close(self):
            pass

    args = types.SimpleNamespace(reps=3, load=1)
    out = bench_daemon._load(Conn, b"{}", {}, args)
    assert calls == ["/synthesize"] * 3
    assert (out["load_completed"], out["load_failures"]) == (2, 1)
