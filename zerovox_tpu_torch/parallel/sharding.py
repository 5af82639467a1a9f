"""Tensor-parallel sharding rules for the zerovox parameter tree.

The port of zerovox_tpu/parallel/sharding.py.  Tensor-parallel layout
follows the Megatron pairing, so that no resharding is needed inside a
block: the first projection of each pair is split on its *output* channels
(column-parallel), the second on its *input* channels (row-parallel: each
device's partial sums are added, in one fixed order, and the sum copied to
every model device).  Instance norms reduce the time axis per channel, so
channel sharding keeps them local; layer norms reduce channels and need the
whole vector.  Embeddings, biases of row-parallel layers, and all small
vectors are replicated.

A spec is the index of the axis a leaf is split on, or None for a
replicated leaf: the counterpart of a PartitionSpec naming the model axis
once.  The port's leaves keep PyTorch's layouts (params.py: Linear (out,
in), Conv1d (out, in, K)), so the rules name other axis indices than the
JAX package's ((in, out) and (K, in, out)) for the same split; the paths
and the choice of leaves are the same.  Shards follow torch.tensor_split
(uneven splits give the first devices one more channel, where GSPMD pads).

Batch data-parallelism splits the leading axis of activations over "data".
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..params import tree_map
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

Spec = Optional[int]


def _spec_for(path: tuple, shape: tuple) -> Spec:
    """The split axis of one parameter (path in the tree, the port's layout)."""
    section = path[0]
    leaf = path[-1]

    if section == "encoder":
        if path[1] == "layers":
            if path[3] == "attn":
                # qkv column-parallel (heads split), out-projection row-parallel
                if leaf in ("wq", "wk", "wv", "bq", "bk", "bv"):
                    return 0
                if leaf == "wo":
                    return 1
                return None                        # bo, ln_g, ln_b
            # ffn: w1 column-parallel on the hidden channels, w2 row-parallel
            if leaf in ("w1", "b1"):
                return 0
            if leaf == "w2":
                return 1
            return None
        if leaf in ("conv1_w", "conv1_b"):         # variance predictors
            return 0
        if leaf == "conv2_w":
            return 1
        return None                                # embeddings, norms, linear

    if section == "decoder":
        if leaf in ("conv1_w", "conv1_b"):
            return 0
        if leaf == "conv2_w":
            return 1
        return None

    if section == "vocoder":
        # channels shrink toward the waveform; split only where they are wide
        if leaf in ("w", "conv1_w", "input_conv_w") and len(shape) == 3 and shape[0] >= 64:
            return 0
        if leaf == "input_conv_b" and shape[0] >= 64:
            return 0
        return None

    return None


def param_partition_specs(params: Dict[str, Any]):
    """Tree of specs (split axis or None) mirroring the params tree."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return _spec_for(path, tuple(node.shape))

    return walk(params, ())


def replicated_specs(params):
    return tree_map(lambda _: None, params)


def _spec_tree_map(fn, params, specs):
    """fn(leaf, spec) over the params tree (specs may hold None leaves)."""
    if isinstance(params, dict):
        return {k: _spec_tree_map(fn, params[k], specs[k]) for k in params}
    if isinstance(params, list):
        return [_spec_tree_map(fn, p, s) for p, s in zip(params, specs)]
    return fn(params, specs)


def shard_params(params, mesh: Mesh, specs=None) -> np.ndarray:
    """Per-device shards of the params tree: an object array shaped like
    mesh.devices whose entry (i, k) is the tree device (i, k) holds, every
    split leaf cut to its k-th tensor_split piece on the model axis.  specs
    default to the tensor-parallel rules on a mesh with a model axis, else
    to replicas.  Devices of one model column hold the same shard; where a
    mesh repeats a device, the tree is made once for it."""
    n_model = mesh.shape[MODEL_AXIS]
    if specs is None:
        specs = (param_partition_specs(params) if n_model > 1
                 else replicated_specs(params))
    out = np.empty(mesh.devices.shape, dtype=object)
    made = {}
    for (i, k), dev in np.ndenumerate(mesh.devices):
        if (k, dev) not in made:
            made[k, dev] = _spec_tree_map(
                lambda t, s: (t if s is None else
                              t.tensor_split(n_model, dim=s)[k].contiguous()).to(dev),
                params, specs)
        out[i, k] = made[k, dev]
    return out


def batch_specs() -> int:
    """Spec of batched activations: the leading axis, split over "data"."""
    return 0


def shard_batch(batch, mesh: Mesh):
    """Each array of `batch` (a tuple or list of arrays, or one array) split
    into mesh.shape["data"] row blocks, block i on the first device of data
    row i: a list per array.  The sharded functions take these or whole
    arrays."""
    def split(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        n = mesh.shape[DATA_AXIS]
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over "
                             f"data={n} devices")
        return [part.to(dev) for part, dev in
                zip(x.tensor_split(n, dim=batch_specs()), mesh.devices[:, 0])]

    if isinstance(batch, (tuple, list)):
        return type(batch)(split(x) for x in batch)
    return split(batch)
