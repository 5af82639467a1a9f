"""Training command line: dataset -> fit() -> GGUF export, on one card.

The port of zerovox_tpu/training/cli.py:

  python -m zerovox_tpu_torch.training.cli --data data.npz --epochs 5 \\
      --batch-size 8 --val-split 0.1 --checkpoint-dir ck/ --export m.gguf

Dataset format: one .npz with the TrainBatch arrays, each with a leading
ndata axis:
  src_seq (N, P) int, puncts (N, P) int, style_embed (N, d_model) f32,
  num_phonemes (N,) int, durations (N, P) int (teacher forcing),
  mel_target (N, T, num_mels) f32, wav_target (N, T*hop) f32.
--synthetic N draws a random dataset at the model geometry (the JAX
package's draws, seed for seed).

It trains on --device (default cuda; without a card that raises, it does
not fall back to the CPU).  --checkpoint-dir resumes: running the same
command again continues from the directory's latest step.  Not carried
over yet: --mesh (the multi-device regimes) and --compile-cache.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .train import TrainBatch


def load_dataset_npz(path: str, cfg) -> TrainBatch:
    try:
        z = np.load(path)
    except (OSError, ValueError) as e:
        raise SystemExit(f"cannot read dataset {path}: {e}")
    missing = [k for k in TrainBatch._fields if k not in z]
    if missing:
        raise SystemExit(f"{path}: missing arrays {missing} "
                         f"(need {list(TrainBatch._fields)})")
    n = z["src_seq"].shape[0]
    shapes = dict(
        src_seq=(n, cfg.max_n_phonemes), puncts=(n, cfg.max_n_phonemes),
        style_embed=(n, cfg.d_model), num_phonemes=(n,),
        durations=(n, cfg.max_n_phonemes),
        mel_target=(n, cfg.max_seq_len, cfg.num_mels),
        wav_target=(n, cfg.wav_len))
    for k, want in shapes.items():
        if tuple(z[k].shape) != want:
            raise SystemExit(f"{path}: {k} has shape {z[k].shape}, "
                             f"model geometry wants {want}")
    return TrainBatch(**{k: z[k] for k in TrainBatch._fields})


def synthetic_dataset(cfg, n: int, seed: int = 0) -> TrainBatch:
    rng = np.random.default_rng(seed)
    P = cfg.max_n_phonemes
    return TrainBatch(
        src_seq=rng.integers(1, cfg.num_phonemes, size=(n, P)).astype(np.int32),
        puncts=rng.integers(0, cfg.num_puncts, size=(n, P)).astype(np.int32),
        style_embed=rng.normal(scale=0.1, size=(n, cfg.d_model)).astype(np.float32),
        num_phonemes=np.full((n,), P, np.int32),
        durations=rng.integers(1, 4, size=(n, P)).astype(np.int32),
        mel_target=rng.normal(size=(n, cfg.max_seq_len, cfg.num_mels)).astype(np.float32),
        wav_target=rng.normal(scale=0.1, size=(n, cfg.wav_len)).astype(np.float32),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="zerovox_tpu_torch.training",
        description="Train zerovox (teacher-forced FS2+StyleTTS+HiFiGAN) on one card")
    src_grp = ap.add_mutually_exclusive_group(required=True)
    src_grp.add_argument("--data", help=".npz dataset (see module docstring)")
    src_grp.add_argument("--synthetic", type=int, metavar="N",
                         help="random N-datum dataset (smoke/scaling runs)")
    ap.add_argument("--init", help="GGUF checkpoint to start from (default: random init)")
    ap.add_argument("--tiny", action="store_true",
                    help="TINY geometry (CPU smoke; default: production)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--val-split", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr-schedule", choices=("constant", "cosine"), default="constant",
                    help="cosine: linear warmup then cosine decay to lr/10 over the "
                         "run's total optimizer steps")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear LR warmup steps (either schedule)")
    ap.add_argument("--weight-decay", type=float, default=1e-2)
    ap.add_argument("--no-stft", action="store_true",
                    help="skip the multi-resolution STFT loss (no vocoder gradient; "
                         "much cheaper)")
    ap.add_argument("--accum", type=int, default=1, metavar="K",
                    help="gradient accumulation: each step's batch as K microbatches "
                         "(activation memory of batch/K rows)")
    ap.add_argument("--checkpoint-dir",
                    help="TrainState checkpoints; an existing dir resumes from its "
                         "latest step")
    ap.add_argument("--checkpoint-every", type=int, default=100,
                    help="optimizer steps between checkpoints")
    ap.add_argument("--export", help="write weights-only GGUF here at the end")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu for the plain "
                         "path without a card)")
    args = ap.parse_args(argv)
    if args.epochs < 1:
        ap.error(f"--epochs must be >= 1 (got {args.epochs})")
    if args.accum < 1:
        raise SystemExit(f"--accum must be >= 1 (got {args.accum})")
    if args.warmup_steps < 0:
        raise SystemExit(f"--warmup-steps must be >= 0 (got {args.warmup_steps})")
    if args.batch_size % args.accum:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by --accum "
                         f"{args.accum} (each microbatch is batch/accum rows)")

    from ..config import TINY_CONFIG, ZeroVoxConfig
    from ..device import resolve_device
    from ..params import init_params, load_params
    from .checkpoint import CheckpointManager, export_weights_gguf
    from .fit import fit, make_eval_fn
    from .train import make_lr_schedule, make_optimizer, make_train_step

    dev = resolve_device(args.device)
    if args.init:
        cfg, params = load_params(args.init, device=dev)
        print(f"train: initialized from {args.init}", file=sys.stderr)
    else:
        cfg = TINY_CONFIG if args.tiny else ZeroVoxConfig()
        params = init_params(cfg, seed=args.seed, device=dev)

    data = (load_dataset_npz(args.data, cfg) if args.data
            else synthetic_dataset(cfg, args.synthetic, seed=args.seed))
    ndata = data.src_seq.shape[0]

    use_stft = not args.no_stft
    # small geometries need STFT windows that fit their waveform
    stft_res = ((256, 30, 120), (128, 15, 60)) if cfg.wav_len < 16384 else None
    # the schedule horizon is fit()'s step count: fit splits BATCHES, not
    # rows (nbatches = ndata // batch; train batches = int((1 - val) * nbatches))
    nbatches = max(1, ndata // args.batch_size)
    total_steps = max(1, int((1.0 - args.val_split) * nbatches)) * args.epochs
    lr = make_lr_schedule(args.lr, total_steps, schedule=args.lr_schedule,
                          warmup_steps=args.warmup_steps)
    optimizer = make_optimizer(lr, args.weight_decay)
    state, step = make_train_step(cfg, params, optimizer=optimizer, device=dev,
                                  use_stft=use_stft, stft_resolutions=stft_res,
                                  accum_steps=args.accum)
    eval_fn = (make_eval_fn(cfg, use_stft=use_stft, stft_resolutions=stft_res)
               if args.val_split > 0 else None)

    mgr = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        last = mgr.latest_step()
        if last is not None:
            state = mgr.restore(state)
            print(f"train: resumed from step {last} ({args.checkpoint_dir})", file=sys.stderr)

    print(f"train: device={dev} ndata={ndata} batch={args.batch_size} "
          f"accum={args.accum} epochs={args.epochs} val_split={args.val_split} "
          f"stft={use_stft}", file=sys.stderr)
    t0 = time.time()
    try:
        state, history = fit(
            state, step, data, batch_size=args.batch_size, epochs=args.epochs,
            val_split=args.val_split, eval_fn=eval_fn, seed=args.seed,
            checkpoint_manager=mgr, checkpoint_every=args.checkpoint_every, silent=False)
    finally:
        if mgr is not None:
            try:
                mgr.save(state, wait=True)   # always leave a resumable state
            finally:
                mgr.close()
    print(f"train: {state.step} total steps, final train loss "
          f"{history[-1]['train_loss']:.6f} ({time.time() - t0:.1f}s)", file=sys.stderr)

    if args.export:
        export_weights_gguf(args.export, state, cfg)
        print(f"train: exported weights to {args.export}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
