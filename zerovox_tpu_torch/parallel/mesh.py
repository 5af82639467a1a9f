"""Device meshes: a (data, model) grid of torch devices.

The port of zerovox_tpu/parallel/mesh.py.  One process drives every device
of a mesh (the counterpart of the JAX package's single-controller meshes):

  "data"  — batch data-parallelism (utterances)
  "model" — tensor-parallel channel sharding of the wide matmuls and convs

`Mesh.devices` is a numpy object array of shape (data, model) and
`Mesh.shape` the dict {"data": d, "model": m}, read as in JAX:
``mesh.shape.get(MODEL_AXIS, 1)``, ``mesh.devices.flat``.

A mesh may name one device several times, but only when the caller passes
`devices=` explicitly: it is the port's counterpart of XLA's forced host
device count.  The CPU tests build their meshes so, from torch.device("cpu")
repeated, and a machine with one card runs every regime on "cuda:0"
repeated.  Every regime computes on such a mesh exactly what it computes on
distinct devices; where the devices are one, the copies between them cost
nothing and their work runs one after the other.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh(NamedTuple):
    devices: np.ndarray          # (data, model) object array of torch.device
    # the data rows this process drives; None: every row.  Only a mesh over
    # several processes (distributed.make_pod_mesh) sets it, and only the
    # sharded train step reads it: the serving regimes drive every row.
    local_rows: Optional[Tuple[int, ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        d, m = self.devices.shape
        return {DATA_AXIS: d, MODEL_AXIS: m}


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh.  Defaults to every CUDA device on the data
    axis (raising without a card, as every entry point of the port does).
    devices: the devices in mesh order, any torch device names; the same
    device may appear more than once only here."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, model))


def single_device_mesh(device="cuda") -> Mesh:
    return make_mesh(data=1, model=1, devices=[device])


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """Parse a CLI "DATA,MODEL" mesh string -> (data, model).

    Raises ValueError with the JAX package's user-facing message."""
    try:
        d, m = (int(x) for x in spec.split(","))
    except ValueError:
        raise ValueError(f"--mesh {spec!r} is not DATA,MODEL "
                         "(two comma-separated ints, e.g. --mesh 4,2)")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec!r}: axis sizes must be >= 1")
    return d, m
