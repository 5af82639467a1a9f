"""The port stands alone: it imports neither jax nor zerovox_tpu, its entry
points default to the card and raise here rather than run on the CPU, and
chip_smoke.py refuses to run without a card or outside a checkout."""

import ast
import importlib.util
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {root!r})
import zerovox_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(zerovox_tpu_torch.__path__,
                                              "zerovox_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import os
ex = os.path.join({root!r}, "examples_torch")
sys.path.insert(0, ex)
scripts = sorted(f for f in os.listdir(ex) if f[0].isdigit() and f.endswith(".py"))
for f in scripts:
    spec = importlib.util.spec_from_file_location("example_" + f[:2], os.path.join(ex, f))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert len(scripts) == 6, scripts
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "zerovox_tpu"))
print(len(mods), bad)
assert not bad, bad
assert len(mods) >= 67, mods
tools = {{"zerovox_tpu_torch.tools." + t for t in (
    "measure", "bench", "bench_daemon", "measure_daemon_attrib", "profile_trace",
    "profile_mel", "profile_breakdown")}}
assert tools <= set(mods), tools - set(mods)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")


def test_port_sources_import_no_jax():
    """No import statement of the port, its examples or chip_smoke.py, at
    module level or inside a function, names jax, jaxlib or zerovox_tpu."""
    files = [*(ROOT / "zerovox_tpu_torch").rglob("*.py"), *(ROOT / "examples_torch").glob("*.py"),
             ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            bad += [f"{f.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "zerovox_tpu")]
    assert len(files) > 60 and not bad, bad


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA card")


def test_entry_points_default_to_cuda():
    _no_cuda()
    import zerovox_tpu_torch as zt
    from zerovox_tpu_torch import cli
    from zerovox_tpu_torch.params import load_params
    from zerovox_tpu_torch.training import cli as train_cli
    from zerovox_tpu_torch.training import make_train_step
    cfg = zt.TINY_CONFIG
    params = zt.init_params(cfg, seed=0, device="cpu")
    P = cfg.max_n_phonemes
    src = np.ones((1, P), np.int32)
    style = np.zeros((1, cfg.d_model), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zt.TTSEngine(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zt.TTSEngine(params, cfg, precision="bfloat16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zt.StreamingSynthesizer(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zt.synthesize(params, cfg, src, src, style)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zt.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params("unused.gguf")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--model", "unused.gguf", "--demo"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--model", "unused.gguf", "--serve", "--port", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):     # before the reference is sought
        cli.main(["--model", "unused.gguf", "--verify"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--synthetic", "2", "--tiny", "--batch-size", "2"])
    from zerovox_tpu_torch import parallel
    from zerovox_tpu_torch.runtime.tp_engine import TPServingEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_mesh(data=1, model=2, devices=["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_sharded_synthesize(cfg, parallel.make_mesh(), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.TimeParallelVocoder(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.PipelinedTTS(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPServingEngine(params, cfg, parallel.make_mesh(model=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--model", "unused.gguf", "--serve", "--port", "0", "--mesh", "2,1"])
    from zerovox_tpu_torch.training import make_sharded_train_step
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sharded_train_step(cfg, parallel.make_mesh(), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_pod_mesh(hosts=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):     # before any connection
        parallel.initialize_distributed("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--synthetic", "2", "--tiny", "--batch-size", "2", "--mesh", "1,1"])
    from zerovox_tpu_torch.tools import (bench, bench_daemon, measure_daemon_attrib,
                                         profile_breakdown, profile_mel, profile_trace)
    for tool in (bench, bench_daemon, measure_daemon_attrib, profile_breakdown, profile_mel,
                 profile_trace):                 # the measurement tools: --device cpu or a card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(["--tiny"])
    # the daemon binds its socket first, then raises and gives the port back
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zt.TTSServer(params, cfg, port=port)
    again = socket.socket()
    again.bind(("127.0.0.1", port))
    again.close()


def test_examples_default_to_cuda(tmp_path):
    """Each examples_torch/ script, run without --device cpu where there is
    no card, raises through device.resolve_device before any work: nothing
    runs on the CPU, and nothing is written."""
    _no_cuda()
    sys.path.insert(0, str(ROOT / "examples_torch"))
    try:
        for path in sorted((ROOT / "examples_torch").glob("[0-9]*.py")):
            spec = importlib.util.spec_from_file_location("example_" + path.name[:2], path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                mod.main(["--out-dir", str(tmp_path)])
    finally:
        sys.path.remove(str(ROOT / "examples_torch"))
        sys.modules.pop("_common", None)
    assert not list(tmp_path.iterdir())


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    _no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
