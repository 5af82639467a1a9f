"""The port's runs of several processes (zerovox_tpu_torch.parallel.distributed)
on the CPU: the pod layout and its errors against the JAX package's, the
backend rule, one two-process gloo run of the port's worker (a reduction
across the processes and one sharded TINY step, its loss equal in both
processes and to the same step in one process), and the training CLI
launched and resumed as two processes (tests/test_distributed_multiproc.py's
test of the JAX CLI).  Every subprocess is bounded: a process that does not
end in time is killed with the other."""

import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from zerovox_tpu.parallel import distributed as jdist

from zerovox_tpu_torch.parallel import distributed as tdist
from zerovox_tpu_torch.params import tree_leaves
from zerovox_tpu_torch.tools.distributed_worker import launch

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
TIMEOUT = 240


class FakeDevice:
    """A device that names its process, as a JAX device does (not a tuple:
    numpy would unpack one into the grid)."""

    def __init__(self, id: int, process_index: int):
        self.id, self.process_index = id, process_index


def test_initialize_without_environment_returns_false(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.initialize_distributed() is False
    assert tdist.initialize_distributed(num_processes=1) is False
    assert not tdist.is_initialized() and tdist.process_count() == 1
    assert tdist.backend() is None
    tdist.barrier()                                   # no-ops in one process
    tdist.shutdown()
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tdist.initialize_distributed(num_processes=2)


@pytest.mark.parametrize("layout", ["contiguous", "by_process", "interleaved"])
def test_pod_device_grid_matches_jax(layout):
    """The same (hosts, per_host) grid from the same device list: split
    contiguously when no device names another process, grouped by process
    otherwise (also when the list interleaves them)."""
    if layout == "contiguous":
        devices = [FakeDevice(i, 0) for i in range(8)]
    elif layout == "by_process":
        devices = [FakeDevice(i, i // 4) for i in range(8)]
    else:
        devices = [FakeDevice(i, i % 2) for i in range(8)]
    for hosts in (1, 2) if layout != "contiguous" else (1, 2, 4):
        if layout != "contiguous" and hosts == 1:
            continue
        want = jdist.pod_device_grid(devices, hosts)
        got = tdist.pod_device_grid(devices, hosts)
        assert got.shape == want.shape
        assert [d.id for d in got.flat] == [d.id for d in want.flat]


@pytest.mark.parametrize("case", ["indivisible", "uneven", "spans"])
def test_pod_device_grid_errors_match_jax(case):
    devices, hosts = {
        "indivisible": ([FakeDevice(i, 0) for i in range(6)], 4),
        "uneven": ([FakeDevice(i, int(i >= 3)) for i in range(8)], 2),
        "spans": ([FakeDevice(i, i % 4) for i in range(8)], 2),
    }[case]
    with pytest.raises(ValueError) as want:
        jdist.pod_device_grid(devices, hosts)
    with pytest.raises(ValueError) as got:
        tdist.pod_device_grid(devices, hosts)
    assert str(got.value) == str(want.value)


def test_make_pod_mesh_matches_jax():
    """Shapes and the model-axis error as JAX's on the same number of
    devices; a list that names its processes gives this process's rows."""
    cpu = torch.device("cpu")
    for n, hosts, model in ((8, 2, 2), (8, 4, 1), (4, 2, 2), (8, 2, 4)):
        want = jdist.make_pod_mesh(hosts, model, devices=jax.devices()[:n])
        got = tdist.make_pod_mesh(hosts, model, devices=[cpu] * n)
        assert got.shape == dict(want.shape) and got.local_rows is None
    with pytest.raises(ValueError) as want:
        jdist.make_pod_mesh(2, 3, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        tdist.make_pod_mesh(2, 3, devices=[cpu] * 8)
    assert str(got.value) == str(want.value)
    pod = tdist.make_pod_mesh(2, 1, devices=[tdist.ProcessDevice(p, cpu) for p in (0, 0, 1, 1)])
    assert pod.shape == {"data": 4, "model": 1} and pod.local_rows == (0, 1)
    assert list(pod.devices.flat) == [cpu] * 4


@pytest.mark.parametrize("count,local_world,backend,devices", [
    (1, 2, "gloo", [["cuda:0"], ["cuda:0"]]),                 # two ranks share one card
    (4, 2, "nccl", [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]),
    (2, 2, "nccl", [["cuda:0"], ["cuda:1"]]),
    (0, 2, "gloo", [["cpu"], ["cpu"]])])
def test_backend_follows_the_devices(monkeypatch, count, local_world, backend, devices):
    """gloo on the CPU and where processes share a card (NCCL refuses two
    ranks on one device), nccl where each owns distinct cards."""
    kind = "cpu" if count == 0 else "cuda"
    monkeypatch.setattr(tdist, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    for rank in range(local_world):
        got, name, why = tdist.choose_devices(kind, rank, local_world)
        assert name == backend and why
        assert [str(d) for d in got] == devices[rank]


def _checks(out):
    return sorted(line for line in out.splitlines() if line.startswith("CHECK "))


def test_two_process_worker():
    """Two gloo processes, each one model-axis pair of the CPU: the same
    reduction, loss and parameters in both, the loss within rtol 1e-6 of
    the in-process step on the same pod layout (the worker asserts it)."""
    runs = launch([sys.executable, "-m", "zerovox_tpu_torch.tools.distributed_worker",
                   "--device", "cpu", "--model", "2"], 2, timeout=TIMEOUT, cwd=ROOT, env=ENV)
    for rank, (rc, out, err) in enumerate(runs):
        assert rc == 0, f"rank {rank}\n{out}\n{err[-3000:]}"
        assert f"process {rank}/2, backend gloo" in err
    assert _checks(runs[0][1]) == _checks(runs[1][1])
    assert {line.split()[1] for line in _checks(runs[0][1])} == {
        "reduction", "train_loss", "params", "inprocess_step", "done"}


def _run_cli_two_process(extra, ck):
    runs = launch([sys.executable, "-m", "zerovox_tpu_torch.training.cli", "--synthetic", "8",
                   "--tiny", "--batch-size", "8", "--no-stft", "--device", "cpu",
                   "--checkpoint-dir", ck, "--checkpoint-every", "1", *extra],
                  2, timeout=TIMEOUT, cwd=ROOT, env=ENV)
    errs, losses = [], []
    for rank, (rc, out, err) in enumerate(runs):
        assert rc == 0, f"CLI rank {rank}\n{out}\n{err[-3000:]}"
        assert f"train: distributed process {rank}/2" in err
        assert "backend gloo" in err
        assert "mesh={'data': 2, 'model': 1}" in err
        loss = [ln for ln in err.splitlines() if "final train loss" in ln]
        assert loss, err
        losses.append(loss[0].split("final train loss")[1].split()[0])
        errs.append(err)
    assert losses[0] == losses[1], losses
    return errs


def test_training_cli_two_process_launch_and_resume(tmp_path):
    """The training CLI as two processes (the environment torchrun sets):
    both print the same final loss; rank 0 writes the checkpoint and the
    export; a second launch resumes from the checkpoint in both processes."""
    from zerovox_tpu_torch.params import load_params
    ck, export = str(tmp_path / "ck"), str(tmp_path / "m.gguf")
    errs = _run_cli_two_process(["--epochs", "1", "--export", export], ck)
    assert all("resumed" not in e for e in errs)
    assert all("1 total steps" in e for e in errs)
    assert "exported weights" in errs[0] and "exported weights" not in errs[1]
    _, params = load_params(export, device="cpu")
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))

    errs = _run_cli_two_process(["--epochs", "1"], ck)
    assert all("resumed from step 1" in e for e in errs)
    assert all("2 total steps" in e for e in errs)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_1.pt", "step_2.pt"]
