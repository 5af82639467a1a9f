"""Several processes training together: torch.distributed and the pod mesh.

The port of zerovox_tpu/parallel/distributed.py.  Every process runs the
same program (the training CLI under torchrun, or launched by hand with the
environment set); `initialize_distributed` joins them into one process
group, and `make_pod_mesh` lays a (data, model) mesh over all their
devices: the data axis spans the processes and the model axis stays inside
one process's devices, so tensor-parallel copies never leave a process and
only the data axis's sums cross between processes.

Each process drives its own rows of the pod mesh (`Mesh.local_rows`); the
sharded train step adds its rows' loss sums and gradients and finishes the
data axis's sums with `all_reduce_sum` across processes.

The backend follows the devices:
  * gloo for processes on the CPU, and for processes that share one card
    (NCCL refuses two ranks on one device);
  * nccl where every process owns distinct cards.
The choice is printed; a failure is raised as it is, never retried on the
other backend.

A single process needs none of this: `initialize_distributed` is then a
no-op that returns False, and `make_pod_mesh` lays the pod layout over the
devices of one process (how the tests and the dry run exercise it).
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .mesh import Mesh

TIMEOUT = datetime.timedelta(seconds=600)


class ProcessDevice(NamedTuple):
    """One device of one process of the run: the counterpart of a JAX
    device's process_index."""
    process_index: int
    device: torch.device


_run = {"backend": None, "devices": None}      # set by initialize_distributed


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized() -> bool:
    return _dist().is_available() and _dist().is_initialized()


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The process group's backend ("gloo" or "nccl"), None in one process."""
    return _run["backend"] if is_initialized() else None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def choose_devices(device, local_rank: int, local_world: int):
    """(this process's devices, backend, why) for a process that is
    `local_rank` of `local_world` processes on its host."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev], "gloo", "CPU processes"
    n = torch.cuda.device_count()
    if n < local_world:
        return ([torch.device("cuda", local_rank % n)], "gloo",
                f"{local_world} processes share {n} card(s); NCCL refuses two ranks on one device")
    per = n // local_world
    return ([torch.device("cuda", local_rank * per + j) for j in range(per)], "nccl",
            f"each process owns {per} distinct card(s)")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> bool:
    """Join a multi-process run; a no-op that returns False in one process.

    Arguments default to torchrun's environment: MASTER_ADDR and
    MASTER_PORT (the coordinator, "host:port"), WORLD_SIZE and RANK; a
    process's devices follow LOCAL_RANK and LOCAL_WORLD_SIZE (default: the
    rank and the world size, one host).  `device` is the kind every process
    trains on (default cuda, which raises without a card; cpu for the CPU).
    Returns True when a process group was made.  Call it before any other
    device work, in every process."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")

    if coordinator_address is None and num_processes in (None, 1):
        return False                      # single-process: nothing to initialize
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed needs the coordinator address, the number of "
            f"processes and this process's id (got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}; torchrun sets MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    devices, name, why = choose_devices(device, local_rank, local_world)
    print(f"distributed: process {process_id}/{num_processes}, backend {name} ({why}), "
          f"devices {[str(d) for d in devices]}", file=sys.stderr, flush=True)
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    _dist().init_process_group(name, init_method=f"tcp://{coordinator_address}",
                               world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    _run.update(backend=name, devices=devices)
    return True


def local_devices() -> List[torch.device]:
    """This process's devices (initialize_distributed chose them)."""
    if not is_initialized():
        raise RuntimeError("local_devices: initialize_distributed has not joined a run")
    return list(_run["devices"])


def global_devices() -> List[ProcessDevice]:
    """Every process's devices, in process order (gathered from each)."""
    names: list = [None] * process_count()
    _dist().all_gather_object(names, [str(d) for d in local_devices()])
    return [ProcessDevice(p, torch.device(n)) for p, ds in enumerate(names) for n in ds]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over every process, in place; returns t.  Under gloo a CUDA
    tensor goes through host memory (gloo reduces on the host)."""
    dist = _dist()
    if t.device.type == "cuda" and backend() == "gloo":
        host = t.to("cpu")
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def barrier():
    """Wait until every process has reached this point (a no-op in one process)."""
    if is_initialized():
        _dist().barrier()


def shutdown():
    """Leave the run (a no-op in one process)."""
    if is_initialized():
        _dist().destroy_process_group()
        _run.update(backend=None, devices=None)


def pod_device_grid(devices: Sequence, hosts: int) -> np.ndarray:
    """Arrange a global device list as a (hosts, per_host) grid.

    Devices that name their process (ProcessDevice, a JAX device) are
    grouped by it, so that each row's tensor-parallel copies stay inside one
    process; devices that do not (torch devices of one process) are split
    contiguously."""
    n = len(devices)
    if n % hosts != 0:
        raise ValueError(f"{n} devices not divisible by hosts={hosts}")
    per_host = n // hosts
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    rows = None
    if len(by_proc) == hosts:
        rows = [by_proc[k] for k in sorted(by_proc)]
        if any(len(r) != per_host for r in rows):
            # a contiguous reshape of an interleaved list would put devices of
            # different processes in one row
            raise ValueError(
                "uneven devices per process: "
                f"{[len(r) for r in rows]} (expected {per_host} x {hosts})")
    elif len(by_proc) == 1:
        rows = [list(devices)[h * per_host:(h + 1) * per_host] for h in range(hosts)]
    else:
        raise ValueError(
            f"device list spans {len(by_proc)} processes but hosts={hosts}; "
            "hosts must equal the number of processes for a multi-process mesh")
    grid = np.empty((hosts, per_host), dtype=object)
    for h, row in enumerate(rows):
        grid[h, :] = row
    return grid


def make_pod_mesh(hosts: int, model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """(data, model) mesh for a pod: data spans the processes, model stays
    within one process's devices.

    The mesh has shape (hosts * per_host_data, model).  devices default to
    every process's devices in a multi-process run (global_devices), else
    to every CUDA device of this process.  Where the devices name their
    processes, the mesh's local_rows are this process's rows."""
    if devices is None:
        if is_initialized():
            devices = global_devices()
        else:
            resolve_device("cuda")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    grid = pod_device_grid(devices, hosts)         # (hosts, per_host)
    per_host = grid.shape[1]
    if per_host % model != 0:
        raise ValueError(
            f"{per_host} devices per host not divisible by model={model}")
    arr = grid.reshape(hosts, per_host // model, model).reshape(-1, model)
    local_rows = None
    if any(isinstance(d, ProcessDevice) for d in arr.flat):
        me = process_index()
        local_rows = tuple(i for i in range(arr.shape[0]) if arr[i, 0].process_index == me)
    out = np.empty(arr.shape, dtype=object)
    for idx, d in np.ndenumerate(arr):
        out[idx] = d.device if isinstance(d, ProcessDevice) else resolve_device(d)
    return Mesh(out, local_rows)
