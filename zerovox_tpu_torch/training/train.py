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

make_sharded_train_step (a mesh, DP/TP) has no counterpart yet: one card
runs make_train_step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..config import ZeroVoxConfig
from ..device import resolve_device
from ..models import fs2_encoder, hifigan, styletts_decoder
from ..ops import length_regulate
from ..params import tree_leaves, tree_map
from .losses import tts_losses


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
    sync: the clip's decision stays on the device."""

    def init(params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))
        keep = norm < clip_norm
        grads = tree_map(lambda g: torch.where(keep, g, (g / norm) * clip_norm), grads)
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

def loss_fn(params: dict, cfg: ZeroVoxConfig, batch: TrainBatch, use_stft: bool = True,
            stft_resolutions=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, loss dict) of a teacher-forced forward on batch tensors
    that lie where params do.  With use_stft the vocoder runs its
    differentiable route (hifigan.vocode(differentiable=True): plain
    convolutions on any device; the MRF kernel has no backward)."""
    P = batch.src_seq.shape[-1]
    dev = batch.src_seq.device
    attn_mask = (fs2_encoder.phoneme_mask(batch.num_phonemes, P)
                 if cfg.use_attention_mask else None)
    features, log_dur = fs2_encoder.encode(params, cfg, batch.src_seq, batch.puncts,
                                           batch.style_embed, phoneme_mask=attn_mask)
    # teacher forcing: expand with the target durations
    hidden, mel_len = length_regulate(features, batch.durations, cfg.max_seq_len,
                                      num_phonemes=batch.num_phonemes)
    mel = styletts_decoder.decode(params, cfg, hidden, batch.style_embed)

    frame = torch.arange(cfg.max_seq_len, device=dev)
    mel_mask = frame[None, :] < mel_len[:, None]
    pidx = torch.arange(P, device=dev)
    phoneme_mask = pidx[None, :] < batch.num_phonemes[:, None]

    wav_pred = wav_target = None
    if use_stft:
        wav_pred = hifigan.vocode(params, cfg, mel, differentiable=True)
        wav_target = batch.wav_target
    losses = tts_losses(mel, batch.mel_target, mel_mask, log_dur, batch.durations,
                        phoneme_mask, wav_pred, wav_target, stft_resolutions=stft_resolutions)
    return losses["total"], losses


def value_and_grad(params: dict, cfg: ZeroVoxConfig, batch: TrainBatch, use_stft: bool = True,
                   stft_resolutions=None) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(detached loss dict, gradient tree) of loss_fn["total"] with respect
    to every leaf of params; a leaf the loss does not reach gets zeros (the
    vocoder's, without the STFT loss)."""
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        total, losses = loss_fn(live, cfg, batch, use_stft, stft_resolutions)
        leaves = tree_leaves(live)
        grads = iter(torch.autograd.grad(total, leaves, allow_unused=True))

    def take(t):                         # the leaves come back in tree_map's order
        g = next(grads)
        return torch.zeros_like(t) if g is None else g
    return {k: v.detach() for k, v in losses.items()}, tree_map(take, params)


def train_step(state: TrainState, batch: TrainBatch, cfg: ZeroVoxConfig, optimizer: Optimizer,
               use_stft: bool = True, stft_resolutions=None, accum_steps: int = 1
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step; returns (new state, loss dict of device scalars).

    accum_steps > 1 is gradient accumulation: the batch is split into that
    many microbatches of consecutive rows, run one after the other (the
    activation memory of batch / accum_steps rows), and the optimizer sees
    the mean of their gradients and losses.  The leading batch dimension
    must divide by accum_steps.  The per-row masked losses make the mean
    the full-batch loss exactly; the STFT's spectral convergence is
    normalised by a norm over its microbatch, so it is the mean of the
    microbatches' terms, as in the JAX package."""
    if accum_steps <= 1:
        losses, grads = value_and_grad(state.params, cfg, batch, use_stft, stft_resolutions)
    else:
        B = batch.src_seq.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} not divisible by accum_steps={accum_steps}")
        micro = B // accum_steps
        losses = grads = None
        for i in range(accum_steps):
            mb = TrainBatch(*(x[i * micro:(i + 1) * micro] for x in batch))
            l_i, g_i = value_and_grad(state.params, cfg, mb, use_stft, stft_resolutions)
            if grads is None:
                losses, grads = l_i, g_i
            else:
                grads = tree_map(torch.add, grads, g_i)
                losses = {k: v + l_i[k] for k, v in losses.items()}
        inv = 1.0 / accum_steps
        grads = tree_map(lambda g: g * inv, grads)
        losses = {k: v * inv for k, v in losses.items()}
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), losses


def batch_to(batch: TrainBatch, device: torch.device) -> TrainBatch:
    """The batch's arrays (numpy or tensors) as tensors on `device`."""
    return TrainBatch(*(torch.as_tensor(x, device=device) for x in batch))


def make_train_step(cfg: ZeroVoxConfig, params: dict, optimizer: Optional[Optimizer] = None,
                    device="cuda", use_stft: bool = True, stft_resolutions=None,
                    accum_steps: int = 1):
    """(initial state, step) on `device`: params moved there as float32,
    the optimizer's state made there, and step(state, batch) ->
    (state, losses), which moves a batch of numpy arrays or tensors to the
    device first.  The port's make_sharded_train_step on one card."""
    dev = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    params = tree_map(lambda t: t.to(dev, torch.float32), params)
    state = TrainState(params, optimizer.init(params), 0)

    def step(state: TrainState, batch: TrainBatch):
        return train_step(state, batch_to(batch, dev), cfg, optimizer, use_stft,
                          stft_resolutions, accum_steps)
    return state, step
