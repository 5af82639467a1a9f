"""Training step on one card: teacher-forced FastSpeech2 + StyleTTS + HiFi-GAN.

The port of zerovox_tpu/training/train.py.  One step is loss -> gradients
(torch.autograd over the port's parameter tree) -> global-norm clip ->
AdamW, all in float32 with TF32 off (device.full_precision_products, set
once per process where a CUDA device is resolved).  The state is
functional, as the JAX package's: train_step returns a new TrainState and
leaves the old one as it was.

The optimizer is written out here, not taken from torch.optim, so that it
is optax's chain(clip_by_global_norm, adamw) step for step:
  * clip: g * max_norm / norm only when norm >= max_norm (no epsilon;
    torch.nn.utils.clip_grad_norm_ adds 1e-6 and always rescales);
  * AdamW (b1 0.9, b2 0.98, eps 1e-8, eps_root 0): decoupled weight decay
    on every leaf, biases and norms included:
    p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p);
  * the learning rate is schedule(count), count = the updates already
    made, so with warmup the first update has lr 0.

make_sharded_train_step runs the step over a (data, model) mesh: the
batch split over the data rows, each row's forward channel-sharded over
its model-axis devices (parallel.tp) where use_tp, and the data axis's sums
written out (what GSPMD inserts for the JAX package):

  * the loss is the whole batch's, not a mean of the rows' losses: each
    row computes the sums its loss divides (losses.loss_sums), the sums
    are added over the rows (and across processes), losses_from_sums
    makes the loss from them, and each row's backward is driven by the
    loss's gradient with respect to the sums, so the rows' gradients add
    up to the whole batch's exactly (the spectral convergence is a norm
    over the batch, not a per-row term);
  * every row runs its backward on leaves of its own, also where a mesh
    repeats a device and the rows' weights are one tensor; the rows'
    gradients are added in row order onto the master row's devices, so a
    mesh of one card repeated, of the CPU repeated and of distinct cards
    compute the same bits;
  * the optimizer acts once on the master pieces (a split leaf's pieces,
    a replicated leaf once), so the clip's global norm counts a replicated
    leaf once and a split leaf as the sum of its pieces'; the other rows
    get copies of the updated pieces (none where they are the same device).

make_train_step is its (1, 1) case, on one device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..config import ZeroVoxConfig
from ..models import fs2_encoder, hifigan, styletts_decoder
from ..ops import length_regulate
from ..parallel import distributed
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, single_device_mesh
from ..parallel.sharding import param_partition_specs, replicated_specs
from ..parallel.tp import Shards, decode_tp, encode_tp, vocode_tp
from ..params import tree_leaves, tree_map
from .losses import loss_sums, losses_from_sums, tts_losses


class TrainBatch(NamedTuple):
    src_seq: Any        # (B, P) int
    puncts: Any         # (B, P) int
    style_embed: Any    # (B, d_model) float32
    num_phonemes: Any   # (B,) int
    durations: Any      # (B, P) int target frames (teacher forcing)
    mel_target: Any     # (B, T, num_mels) float32
    wav_target: Any     # (B, T * hop) float32


class TrainState(NamedTuple):
    params: dict        # the port's parameter tree (params.py)
    opt_state: dict     # the optimizer's: AdamW {"count", "mu", "nu"}
    step: int           # optimizer steps taken


class Optimizer(NamedTuple):
    """optax's GradientTransformation, on parameter trees:
    init(params) -> state; update(grads, state, params) -> (updates, state)."""
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict], Tuple[dict, dict]]


Schedule = Union[float, Callable[[int], float]]


# --------------------------------------------------------------------------
# learning-rate schedules (optax's, as functions of the update count)
# --------------------------------------------------------------------------

def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:                       # optax: a constant init_value
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine_decay_schedule(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _join_schedules(first, then, boundary: int) -> Callable[[int], float]:
    return lambda count: first(count) if count < boundary else then(count - boundary)


def make_lr_schedule(peak_lr: float, total_steps: int, schedule: str = "constant",
                     warmup_steps: int = 0, end_scale: float = 0.1) -> Schedule:
    """Learning-rate schedule: "constant" (optional linear warmup from 0) or
    "cosine" (linear warmup, then cosine decay to peak_lr * end_scale at
    total_steps; the warmup counts in total_steps, as in optax's
    warmup_cosine_decay_schedule).  Returns a float or a function of the
    update count, both valid `learning_rate` values for make_optimizer."""
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown lr schedule {schedule!r}")
    if warmup_steps < 0:
        raise ValueError(f"warmup_steps must be >= 0 (got {warmup_steps})")
    warmup_steps = min(int(warmup_steps), max(int(total_steps) - 1, 0))
    warmup = _linear_schedule(0.0, peak_lr, warmup_steps)
    if schedule == "cosine":
        end = peak_lr * end_scale
        alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
        decay = _cosine_decay_schedule(peak_lr, max(int(total_steps), 1) - warmup_steps, alpha)
        return _join_schedules(warmup, decay, warmup_steps)
    if warmup_steps > 0:
        return _join_schedules(warmup, lambda count: peak_lr, warmup_steps)
    return peak_lr


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

B1, B2, EPS = 0.9, 0.98, 1e-8      # the JAX package's adamw(b1, b2), optax's eps


def make_optimizer(learning_rate: Schedule = 1e-4, weight_decay: float = 1e-2,
                   clip_norm: float = 1.0) -> Optimizer:
    """AdamW after a global-norm clip: optax.chain(clip_by_global_norm(clip_norm),
    adamw(learning_rate, b1=0.9, b2=0.98, weight_decay=weight_decay)).
    learning_rate may be a float or a schedule (make_lr_schedule).  No host
    sync: the clip's decision stays on the device.  The leaves may lie on
    several devices (a sharded state's pieces): the norm is summed on the
    first leaf's."""

    def init(params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        leaves = tree_leaves(grads)       # on one device, or a mesh's pieces on several
        lead = leaves[0].device
        norm = torch.sqrt(sum(torch.sum(g * g).to(lead) for g in leaves))
        keep = norm < clip_norm

        def clip(g):
            n, k = norm.to(g.device), keep.to(g.device)
            return torch.where(k, g, (g / n) * clip_norm)
        grads = tree_map(clip, grads)
        count = state["count"]
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        mu = tree_map(lambda g, m: (1 - B1) * g + B1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - B2) * (g * g) + B2 * v, grads, state["nu"])
        c1, c2 = 1 - B1 ** (count + 1), 1 - B2 ** (count + 1)
        updates = tree_map(
            lambda m, v, p: -lr * ((m / c1) / (torch.sqrt(v / c2) + EPS) + weight_decay * p),
            mu, nu, params)
        return updates, {"count": count + 1, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: p + u, params, updates)


# --------------------------------------------------------------------------
# loss and step
# --------------------------------------------------------------------------

def _teacher_forced(params: dict, cfg: ZeroVoxConfig, batch: TrainBatch, use_stft: bool,
                    tp: bool = False):
    """The teacher-forced forward: (mel, mel_mask, log_dur, phoneme_mask,
    wav_pred or None).  tp: params is a tensor-parallel view (parallel.tp)
    and the forward runs channel-sharded, the vocoder's wide convs split on
    their output channels; the batch lies on the view's lead."""
    P = batch.src_seq.shape[-1]
    dev = batch.src_seq.device
    if tp:
        features, log_dur = encode_tp(params, cfg, batch.src_seq, batch.puncts,
                                      batch.style_embed, batch.num_phonemes)
    else:
        attn_mask = (fs2_encoder.phoneme_mask(batch.num_phonemes, P)
                     if cfg.use_attention_mask else None)
        features, log_dur = fs2_encoder.encode(params, cfg, batch.src_seq, batch.puncts,
                                               batch.style_embed, phoneme_mask=attn_mask)
    # teacher forcing: expand with the target durations
    hidden, mel_len = length_regulate(features, batch.durations, cfg.max_seq_len,
                                      num_phonemes=batch.num_phonemes)
    if tp:
        mel = decode_tp(params, cfg, hidden, batch.style_embed)
    else:
        mel = styletts_decoder.decode(params, cfg, hidden, batch.style_embed)

    frame = torch.arange(cfg.max_seq_len, device=dev)
    mel_mask = frame[None, :] < mel_len[:, None]
    pidx = torch.arange(P, device=dev)
    phoneme_mask = pidx[None, :] < batch.num_phonemes[:, None]
    wav_pred = None
    if use_stft:
        wav_pred = (vocode_tp(params, cfg, mel) if tp else
                    hifigan.vocode(params, cfg, mel, differentiable=True))
    return mel, mel_mask, log_dur, phoneme_mask, wav_pred


def loss_fn(params: dict, cfg: ZeroVoxConfig, batch: TrainBatch, use_stft: bool = True,
            stft_resolutions=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, loss dict) of a teacher-forced forward on batch tensors
    that lie where params do.  With use_stft the vocoder runs its
    differentiable route (hifigan.vocode(differentiable=True): plain
    convolutions on any device; the MRF kernel has no backward)."""
    mel, mel_mask, log_dur, phoneme_mask, wav_pred = _teacher_forced(params, cfg, batch,
                                                                     use_stft)
    losses = tts_losses(mel, batch.mel_target, mel_mask, log_dur, batch.durations,
                        phoneme_mask, wav_pred, batch.wav_target if use_stft else None,
                        stft_resolutions=stft_resolutions)
    return losses["total"], losses


def value_and_grad(params: dict, cfg: ZeroVoxConfig, batch: TrainBatch, use_stft: bool = True,
                   stft_resolutions=None) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(detached loss dict, gradient tree) of loss_fn["total"] with respect
    to every leaf of params; a leaf the loss does not reach gets zeros (the
    vocoder's, without the STFT loss)."""
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        total, losses = loss_fn(live, cfg, batch, use_stft, stft_resolutions)
        grads = torch.autograd.grad(total, tree_leaves(live), allow_unused=True)
    return {k: v.detach() for k, v in losses.items()}, _grad_tree(params, grads)


def _grad_tree(like, grads) -> dict:
    """The gradients (in tree_leaves order, None where the loss does not
    reach a leaf) as a tree shaped like `like`, zeros for the Nones."""
    it = iter(grads)

    def take(t):
        g = next(it)
        return torch.zeros_like(t) if g is None else g
    return tree_map(take, like)


# --------------------------------------------------------------------------
# the state on a mesh
# --------------------------------------------------------------------------

class MeshTree(dict):
    """A sharded state's parameters: the params tree with each split leaf a
    list of its model-axis pieces, piece k on the master row's device k, and
    each replicated leaf on the master row's first device; `layout` says how
    (TrainLayout).  It is a dict, so tree_map / tree_leaves walk it."""

    def __init__(self, tree: dict, layout: "TrainLayout"):
        super().__init__(tree)
        self.layout = layout


class TrainLayout:
    """Where a training state's tensors lie on a mesh.

    specs: the split axis of each leaf (sharding.param_partition_specs, or
    None everywhere: replicas).  The master row is this process's first
    data row (mesh.local_rows, every row in one process); the other local
    rows hold copies of it (`replicas`), which are the master's tensors
    where a row's devices are the master's."""

    def __init__(self, mesh: Mesh, specs, params: dict, tp: bool):
        self.mesh, self.specs, self.tp = mesh, specs, tp
        # the whole tree's shapes and dtypes, as tensors on the meta device
        self.template = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
        n = mesh.shape[DATA_AXIS]
        self.rows = tuple(range(n)) if mesh.local_rows is None else tuple(mesh.local_rows)
        self.distributed = mesh.local_rows is not None
        self.lead = mesh.devices[self.rows[0], 0]
        self._replicas = (None, None)

    def _walk(self, fn, *trees):
        def walk(spec, *nodes):
            if isinstance(spec, dict):
                return {k: walk(spec[k], *(n[k] for n in nodes)) for k in spec}
            if isinstance(spec, list):
                return [walk(s, *(n[i] for n in nodes)) for i, s in enumerate(spec)]
            return fn(spec, *nodes)
        return walk(self.specs, *trees)

    def _dev(self, row: int, k: int):
        return self.mesh.devices[row, k]

    def scatter(self, full: dict) -> MeshTree:
        """A whole tree (on any device) as master pieces."""
        n_model = self.mesh.shape[MODEL_AXIS]
        r0 = self.rows[0]

        def put(spec, t):
            t = t.detach()
            if spec is None:
                return t.to(self._dev(r0, 0))
            return [p.contiguous().to(self._dev(r0, k))
                    for k, p in enumerate(t.tensor_split(n_model, dim=spec))]
        return MeshTree(self._walk(put, full), self)

    def gather(self, pieces: dict) -> dict:
        """The whole tree of master pieces (params or a moment), on the host."""
        return self._walk(lambda spec, t: t.detach().cpu() if spec is None else
                          torch.cat([p.detach().cpu() for p in t], dim=spec), pieces)

    def replica(self, pieces: dict, row: int) -> dict:
        """The master pieces copied to data row `row`'s devices."""
        return self._walk(lambda spec, t: t.to(self._dev(row, 0)) if spec is None else
                          [p.to(self._dev(row, k)) for k, p in enumerate(t)], pieces)

    def replicas(self, pieces: dict) -> list:
        """One tree per local row (the master for the first), made once per
        state (the last one asked for is kept)."""
        if self._replicas[0] is not pieces:
            self._replicas = (pieces, [pieces if r == self.rows[0] else self.replica(pieces, r)
                                       for r in self.rows])
        return self._replicas[1]

    def view(self, tree: dict) -> dict:
        """A row's tree as parallel.tp reads it: Shards for the split leaves."""
        return self._walk(lambda spec, t: t if spec is None else Shards(tuple(t), spec), tree)

    def split_batch(self, batch: TrainBatch) -> list:
        """A whole (micro)batch as one TrainBatch per local row, on the row's
        first device: row i takes the i-th of data equal blocks."""
        n = self.mesh.shape[DATA_AXIS]
        B = batch.src_seq.shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} rows does not split over data={n} devices")
        b = B // n
        return [TrainBatch(*(x[i * b:(i + 1) * b].to(self._dev(i, 0)) for x in batch))
                for i in self.rows]

    def reduce(self, parts: list) -> torch.Tensor:
        """The local rows' tensors added in row order on the master's device
        (and across processes); a new tensor."""
        acc = parts[0].to(self.lead, copy=True)
        for p in parts[1:]:
            acc = acc + p.to(self.lead)
        return distributed.all_reduce_sum(acc) if self.distributed else acc


def _row_sums(tree: dict, layout: TrainLayout, cfg: ZeroVoxConfig, batch: TrainBatch,
              use_stft: bool, stft_resolutions) -> torch.Tensor:
    """loss_sums of one data row's forward (on the row's tree)."""
    params = layout.view(tree) if layout.tp else tree
    mel, mel_mask, log_dur, phoneme_mask, wav_pred = _teacher_forced(params, cfg, batch,
                                                                     use_stft, layout.tp)
    return loss_sums(mel, batch.mel_target, mel_mask, log_dur, batch.durations, phoneme_mask,
                     wav_pred, batch.wav_target if use_stft else None, stft_resolutions)


def sharded_losses(layout: TrainLayout, pieces: dict, cfg: ZeroVoxConfig, batch: TrainBatch,
                   use_stft: bool = True, stft_resolutions=None) -> Dict[str, torch.Tensor]:
    """The loss dict of the whole batch, forward only (the eval pass)."""
    with torch.no_grad():
        sums = [_row_sums(tree, layout, cfg, b, use_stft, stft_resolutions)
                for tree, b in zip(layout.replicas(pieces), layout.split_batch(batch))]
        return losses_from_sums(layout.reduce(sums))


def _sharded_value_and_grad(layout: TrainLayout, pieces: dict, cfg: ZeroVoxConfig,
                            batch: TrainBatch, use_stft: bool, stft_resolutions):
    """(loss dict, gradient pieces) of the whole batch's loss: the rows'
    forwards, their loss sums added, the loss's gradient with respect to the
    sums, then each row's backward from it; the rows' gradients added in
    row order onto the master's pieces (this process's rows only: across
    processes the caller finishes the sum)."""
    rows = layout.replicas(pieces)
    with torch.enable_grad():
        lives, sums = [], []
        for tree, b in zip(rows, layout.split_batch(batch)):
            live = tree_map(lambda t: t.detach().requires_grad_(), tree)
            sums.append(_row_sums(live, layout, cfg, b, use_stft, stft_resolutions))
            lives.append(live)
        total = layout.reduce([s.detach() for s in sums]).requires_grad_()
        losses = losses_from_sums(total)
        (d_sums,) = torch.autograd.grad(losses["total"], total)
        grads = []
        for tree, live, s in zip(rows, lives, sums):
            g = torch.autograd.grad(s, tree_leaves(live), grad_outputs=d_sums.to(s.device),
                                    allow_unused=True)
            grads.append(_grad_tree(tree, g))
    summed = tree_map(lambda *gs: _add_in_order(gs), *grads)
    return {k: v.detach() for k, v in losses.items()}, summed


def _add_in_order(gs) -> torch.Tensor:
    acc = gs[0]
    for g in gs[1:]:
        acc = acc + g.to(acc.device)
    return acc


def _all_reduce_tree(tree: dict, lead) -> dict:
    """Each leaf summed over every process: one all_reduce of one flat
    buffer on `lead`, the leaves in tree order."""
    leaves = tree_leaves(tree)
    flat = distributed.all_reduce_sum(torch.cat([g.reshape(-1).to(lead) for g in leaves]))
    it, offset = iter(leaves), [0]

    def back(_):
        g = next(it)
        n = g.numel()
        out = flat[offset[0]:offset[0] + n].view(g.shape).to(g.device)
        offset[0] += n
        return out
    return tree_map(back, tree)


def train_step(state: TrainState, batch: TrainBatch, cfg: ZeroVoxConfig, optimizer: Optimizer,
               use_stft: bool = True, stft_resolutions=None, accum_steps: int = 1
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step of a state from make_sharded_train_step (or
    make_train_step); returns (new state, loss dict of device scalars).  The
    batch (numpy arrays or tensors on any device) is split into the data
    rows of the mesh the state lies on (state.params.layout).

    accum_steps > 1 is gradient accumulation: the batch is split into that
    many microbatches of consecutive rows, run one after the other (the
    activation memory of batch / accum_steps rows), each split over the data
    rows, and the optimizer sees the mean of their gradients and losses.
    The batch must divide by accum_steps and each microbatch by the data
    axis.  The per-row masked losses make the mean the full-batch loss
    exactly; the STFT's spectral convergence is normalised by a norm over
    its microbatch, so it is the mean of the microbatches' terms, as in the
    JAX package."""
    layout = state.params.layout
    batch = TrainBatch(*(torch.as_tensor(x) for x in batch))
    B = batch.src_seq.shape[0]
    accum = max(accum_steps, 1)
    if B % accum:
        raise ValueError(f"batch {B} not divisible by accum_steps={accum_steps}")
    micro = B // accum
    losses = grads = None
    for i in range(accum):
        mb = TrainBatch(*(x[i * micro:(i + 1) * micro] for x in batch))
        l_i, g_i = _sharded_value_and_grad(layout, state.params, cfg, mb, use_stft,
                                           stft_resolutions)
        if grads is None:
            losses, grads = l_i, g_i
        else:
            grads = tree_map(torch.add, grads, g_i)
            losses = {k: v + l_i[k] for k, v in losses.items()}
    if accum > 1:
        inv = 1.0 / accum
        grads = tree_map(lambda g: g * inv, grads)
        losses = {k: v * inv for k, v in losses.items()}
    if layout.distributed:
        grads = _all_reduce_tree(grads, layout.lead)
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = MeshTree(apply_updates(state.params, updates), layout)
    return TrainState(params, opt_state, state.step + 1), losses


def batch_to(batch: TrainBatch, device: torch.device) -> TrainBatch:
    """The batch's arrays (numpy or tensors) as tensors on `device`."""
    return TrainBatch(*(torch.as_tensor(x, device=device) for x in batch))


def make_sharded_train_step(cfg: ZeroVoxConfig, mesh: Mesh, params: dict,
                            optimizer: Optional[Optimizer] = None, use_tp: bool = True,
                            use_stft: bool = True, stft_resolutions=None, accum_steps: int = 1):
    """(initial state, step) over `mesh`: the params (in their dtype) as pieces
    of the tensor-parallel rules (sharding.param_partition_specs) where use_tp and
    the mesh has a model axis, else replicas; the optimizer's state made on
    the same pieces; step(state, batch) -> (state, losses), which splits a
    whole batch (numpy arrays or tensors) over the data rows (each
    microbatch under accum_steps must divide by the data axis).  On a mesh
    over several processes (distributed.make_pod_mesh) each process drives
    its rows and passes the whole batch; the losses are the same in every
    process."""
    optimizer = optimizer or make_optimizer()
    tp = use_tp and mesh.shape[MODEL_AXIS] > 1
    specs = param_partition_specs(params) if tp else replicated_specs(params)
    layout = TrainLayout(mesh, specs, params, tp)
    pieces = layout.scatter(params)
    state = TrainState(pieces, optimizer.init(pieces), 0)

    def step(state: TrainState, batch: TrainBatch):
        return train_step(state, batch, cfg, optimizer, use_stft, stft_resolutions,
                          accum_steps)
    return state, step


def make_train_step(cfg: ZeroVoxConfig, params: dict, optimizer: Optional[Optimizer] = None,
                    device="cuda", use_stft: bool = True, stft_resolutions=None,
                    accum_steps: int = 1):
    """make_sharded_train_step on the (1, 1) mesh of `device`: params moved
    there as float32, the optimizer's state made there, and step(state,
    batch) -> (state, losses), which moves a batch of numpy arrays or
    tensors to the device first."""
    params = tree_map(lambda t: t.to(torch.float32), params)
    return make_sharded_train_step(cfg, single_device_mesh(device), params, optimizer,
                                   use_stft=use_stft, stft_resolutions=stft_resolutions,
                                   accum_steps=accum_steps)
