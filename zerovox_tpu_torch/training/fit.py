"""Epoch loop (the port of zerovox_tpu/training/fit.py, ggml-opt's dataset loop).

An in-memory dataset is split into a train and a validation region,
shuffled once whole before the first epoch and in its train region every
epoch after, and walked in fixed-size batches: train batches step the
optimizer, validation batches run the loss-only forward.  With the same
seed the batch order is the JAX package's (the same numpy generator, drawn
the same way).

As in the JAX package: the trailing ndata % batch_size datums are dropped
(one batch shape); the dataset moves to the device once, up front; the
per-batch losses stay on the device and are fetched once per epoch (one
host sync per epoch); checkpoints ride the step cadence.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..params import tree_leaves
from .train import TrainBatch, TrainState, batch_to, loss_fn, sharded_losses


def make_eval_fn(cfg: ZeroVoxConfig, mesh=None, use_stft: bool = True, stft_resolutions=None
                 ) -> Callable[[Any, TrainBatch], Dict[str, torch.Tensor]]:
    """Loss-only forward, under torch.no_grad: eval(params, batch) -> the
    loss dict.  params is a state's params: on a mesh (make_sharded_train_step
    on `mesh`) the batch is split over its data rows and the loss is the
    whole batch's; a plain tree takes a batch that lies where it does (fit
    puts it there)."""
    def eval_losses(params, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        layout = getattr(params, "layout", None)
        if layout is None:
            with torch.no_grad():
                return loss_fn(params, cfg, batch, use_stft=use_stft,
                               stft_resolutions=stft_resolutions)[1]
        if mesh is not None and layout.mesh.devices.shape != mesh.devices.shape:
            raise ValueError(f"eval on mesh {mesh.shape}: the state lies on {layout.mesh.shape}")
        return sharded_losses(layout, params, cfg, batch, use_stft, stft_resolutions)
    return eval_losses


def _take(data: TrainBatch, idx: np.ndarray) -> TrainBatch:
    # `data` lies on the device (fit moves it once); only the index moves per step
    index = torch.as_tensor(idx, device=data.src_seq.device)
    return TrainBatch(*(a[index] for a in data))


def _loss_stats(device_losses: List[torch.Tensor]) -> Tuple[float, float]:
    """(mean, standard error) of the per-batch losses (ddof 1), fetched in
    one transfer."""
    vals = torch.stack(device_losses).cpu().numpy().astype(np.float64)
    sem = (vals.std(ddof=1) / np.sqrt(len(vals))) if len(vals) > 1 else 0.0
    return float(vals.mean()), float(sem)


def fit(state: TrainState,
        step_fn: Callable[[TrainState, TrainBatch], Tuple[TrainState, Dict]],
        data: TrainBatch,
        batch_size: int,
        epochs: int = 1,
        val_split: float = 0.0,
        eval_fn: Optional[Callable[[Any, TrainBatch], Dict]] = None,
        shuffle: bool = True,
        seed: int = 0,
        checkpoint_manager=None,
        checkpoint_every: int = 0,
        callback: Optional[Callable] = None,
        silent: bool = True,
        ) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Train `state` over `data` for `epochs`; returns (state, history).

    data: a TrainBatch of arrays with a leading ndata axis; it is moved once
      to the device the state's params lie on (a sharded state's: its
      master row's first device).
    step_fn: from make_sharded_train_step or make_train_step (or any
      (state, batch) -> (state, losses)); a sharded step splits each batch
      over its mesh's data rows.
    val_split: trailing fraction of the (once-shuffled) batches reserved for
      the loss-only pass each epoch.
    eval_fn: from make_eval_fn; required when val_split leaves validation
      batches.
    callback(train, epoch, ibatch, nbatches, loss): per-batch progress hook;
      `loss` is a DEVICE scalar (fetching it is a host sync).
    checkpoint_every: save through checkpoint_manager every N optimizer
      steps (0 = never).
    history: per epoch {"epoch", "train_loss", "train_loss_unc",
      "val_loss", "val_loss_unc", "seconds"}.
    """
    if not 0.0 <= val_split < 1.0:
        raise ValueError(f"val_split must be in [0, 1), got {val_split}")
    ndata = int(np.shape(data.src_seq)[0])
    if batch_size > ndata:
        raise ValueError(f"batch_size {batch_size} > dataset size {ndata}")
    nbatches = ndata // batch_size
    dropped = ndata - nbatches * batch_size
    if dropped and not silent:
        print(f"fit: dropping {dropped} trailing datums "
              f"(ndata {ndata} % batch_size {batch_size})", file=sys.stderr)
    ibatch_split = int((1.0 - val_split) * nbatches)
    if ibatch_split == 0:
        raise ValueError("val_split leaves no training batches")
    if ibatch_split < nbatches and eval_fn is None:
        raise ValueError("val_split > 0 requires eval_fn (make_eval_fn)")
    idata_split = ibatch_split * batch_size

    data = batch_to(data, tree_leaves(state.params)[0].device)

    rng = np.random.default_rng(seed)
    order = np.arange(ndata)
    if shuffle and batch_size < ndata:
        rng.shuffle(order)                 # whole-set shuffle, once
    history: List[Dict[str, float]] = []

    for epoch in range(1, epochs + 1):
        if shuffle and batch_size < idata_split:
            order[:idata_split] = rng.permutation(order[:idata_split])
        t0 = time.time()
        train_losses: List[torch.Tensor] = []
        for ib in range(ibatch_split):
            batch = _take(data, order[ib * batch_size:(ib + 1) * batch_size])
            state, losses = step_fn(state, batch)
            train_losses.append(losses["total"])
            if callback is not None:
                callback(True, epoch, ib + 1, ibatch_split, losses["total"])
            if (checkpoint_manager is not None and checkpoint_every
                    and (ib + 1 + (epoch - 1) * ibatch_split) % checkpoint_every == 0):
                checkpoint_manager.save(state)
        val_losses: List[torch.Tensor] = []
        for ib in range(ibatch_split, nbatches):
            batch = _take(data, order[ib * batch_size:(ib + 1) * batch_size])
            losses = eval_fn(state.params, batch)
            val_losses.append(losses["total"])
            if callback is not None:
                callback(False, epoch, ib + 1 - ibatch_split, nbatches - ibatch_split,
                         losses["total"])

        train_mean, train_unc = _loss_stats(train_losses)
        entry = {"epoch": epoch, "train_loss": train_mean,
                 "train_loss_unc": train_unc, "seconds": time.time() - t0}
        if val_losses:
            entry["val_loss"], entry["val_loss_unc"] = _loss_stats(val_losses)
        history.append(entry)
        if not silent:
            line = f"fit: epoch {epoch:04d}/{epochs:04d} train={train_mean:.6f}+-{train_unc:.6f}"
            if val_losses:
                line += f" val={entry['val_loss']:.6f}+-{entry['val_loss_unc']:.6f}"
            print(line + f" ({entry['seconds']:.1f}s)", file=sys.stderr, flush=True)
    return state, history
