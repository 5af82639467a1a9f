"""Training: losses, AdamW with clipping and schedules, the train step with
gradient accumulation on one card (make_train_step) or over a mesh of
cards and processes (make_sharded_train_step), the epoch loop,
checkpoints and the GGUF export (the port of zerovox_tpu.training)."""

from .losses import tts_losses, stft_loss, masked_l1, masked_mse
from .train import (TrainBatch, TrainState, make_optimizer, make_lr_schedule, loss_fn,
                    train_step, make_train_step, make_sharded_train_step)
from .fit import fit, make_eval_fn

__all__ = ["tts_losses", "stft_loss", "masked_l1", "masked_mse",
           "TrainBatch", "TrainState", "make_optimizer", "make_lr_schedule",
           "loss_fn", "train_step", "make_train_step", "make_sharded_train_step", "fit", "make_eval_fn"]
