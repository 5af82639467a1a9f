"""Training command line: dataset -> fit() -> GGUF export, on a mesh of cards.

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
not fall back to the CPU) over every visible card on the data axis, or
--mesh DATA,MODEL distinct cards (MODEL > 1: channel tensor parallelism;
not with --device cpu).  --checkpoint-dir resumes: running the same command
again continues from the directory's latest step.  --compile-cache DIR
keeps the compiled libraries (the MRF kernel's nvcc builds, the native
loader) in DIR, so another process finds them built.

Several processes train together when the environment names a run
(torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK):

  torchrun --nproc-per-node 2 -m zerovox_tpu_torch.training.cli --synthetic 8 \
      --batch-size 8 --checkpoint-dir ck/

The mesh is then the pod layout over every process's devices
(parallel.distributed.make_pod_mesh: data across processes, --mesh's MODEL
within each); the backend is gloo where processes share a card or run on
the CPU, nccl where each owns distinct cards.  Rank 0 alone writes the
checkpoints and the export; every process restores and prints the same
final loss.
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
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="device mesh split (default: every card on data)")
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
    ap.add_argument("--compile-cache", metavar="DIR",
                    help="keep the compiled libraries (the MRF kernel's nvcc builds, the "
                         "native loader) under DIR: another process finds them built")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu for the plain "
                         "path without a card)")
    args = ap.parse_args(argv)
    if args.epochs < 1:
        ap.error(f"--epochs must be >= 1 (got {args.epochs})")
    if args.mesh and args.device == "cpu":
        ap.error("--mesh spans CUDA devices; it does not run with --device cpu")
    if args.accum < 1:
        raise SystemExit(f"--accum must be >= 1 (got {args.accum})")
    if args.warmup_steps < 0:
        raise SystemExit(f"--warmup-steps must be >= 0 (got {args.warmup_steps})")
    if args.batch_size % args.accum:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by --accum "
                         f"{args.accum} (each microbatch is batch/accum rows)")

    if args.compile_cache:
        from ..utils.compile_cache import enable_compile_cache
        print(f"train: compile cache {enable_compile_cache(args.compile_cache)}",
              file=sys.stderr)

    from ..parallel import distributed

    # a run of several processes: every process runs this same command with
    # the environment set (torchrun); before any other device work
    is_dist = distributed.initialize_distributed(device=args.device)
    rank = distributed.process_index()
    if is_dist:
        print(f"train: distributed process {rank}/{distributed.process_count()}",
              file=sys.stderr)
    try:
        return _train(ap, args, is_dist, rank)
    finally:
        distributed.shutdown()


def _train(ap, args, is_dist: bool, rank: int) -> int:
    from ..config import TINY_CONFIG, ZeroVoxConfig
    from ..parallel import distributed, make_mesh, parse_mesh_spec
    from ..params import init_params, load_params
    from .checkpoint import CheckpointManager, export_weights_gguf
    from .fit import fit, make_eval_fn
    from .train import make_lr_schedule, make_optimizer, make_sharded_train_step

    d, m = None, 1
    if args.mesh:
        try:
            d, m = parse_mesh_spec(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    if is_dist:
        # the pod layout: data spans the processes, model stays inside one
        # process's devices; only --mesh's model part is honoured
        mesh = distributed.make_pod_mesh(hosts=distributed.process_count(), model=m)
        if args.mesh and mesh.shape["data"] != d:
            print(f"train: distributed mode derives the data axis from the "
                  f"global device count; --mesh data={d} ignored "
                  f"(using {mesh.shape['data']})", file=sys.stderr)
    elif args.mesh or args.device == "cuda":
        mesh = make_mesh(data=d, model=m)          # default: every card on the data axis
    else:                                          # one named device (cpu, cuda:1, ...)
        mesh = make_mesh(data=1, model=1, devices=[args.device])
    dev = mesh.devices[mesh.local_rows[0] if mesh.local_rows else 0, 0]

    if args.init:
        cfg, params = load_params(args.init, device=dev)
        print(f"train: initialized from {args.init}", file=sys.stderr)
    else:
        cfg = TINY_CONFIG if args.tiny else ZeroVoxConfig()
        params = init_params(cfg, seed=args.seed, device=dev)

    data = (load_dataset_npz(args.data, cfg) if args.data
            else synthetic_dataset(cfg, args.synthetic, seed=args.seed))
    ndata = data.src_seq.shape[0]

    d = mesh.shape["data"]
    if args.batch_size % d:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by the "
                         f"data-axis size {d}")
    if args.batch_size % (args.accum * d):
        raise SystemExit(
            f"--batch-size {args.batch_size} must divide by "
            f"accum*data = {args.accum}*{d} (each microbatch is "
            f"batch/accum rows, still sharded over the data axis)")

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
    state, step = make_sharded_train_step(cfg, mesh, params, optimizer=optimizer,
                                          use_stft=use_stft, stft_resolutions=stft_res,
                                          accum_steps=args.accum)
    eval_fn = (make_eval_fn(cfg, mesh, use_stft=use_stft, stft_resolutions=stft_res)
               if args.val_split > 0 else None)

    mgr = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        last = mgr.latest_step()
        if last is not None:
            state = mgr.restore(state)       # every process restores
            print(f"train: resumed from step {last} ({args.checkpoint_dir})", file=sys.stderr)
        if rank != 0:                         # rank 0 alone writes
            mgr.close()
            mgr = None

    print(f"train: mesh={dict(mesh.shape)} devices={_device_names(mesh)} ndata={ndata} "
          f"batch={args.batch_size} accum={args.accum} epochs={args.epochs} "
          f"val_split={args.val_split} stft={use_stft}", file=sys.stderr)
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
    distributed.barrier()                     # the checkpoint is whole for every process
    print(f"train: {state.step} total steps, final train loss "
          f"{history[-1]['train_loss']:.6f} ({time.time() - t0:.1f}s)", file=sys.stderr)

    if args.export:
        if rank == 0:
            export_weights_gguf(args.export, state, cfg)
            print(f"train: exported weights to {args.export}", file=sys.stderr)
        distributed.barrier()
    return 0


def _device_names(mesh) -> str:
    names = [str(d) for d in mesh.devices.flat]
    return ",".join(dict.fromkeys(names))


if __name__ == "__main__":
    sys.exit(main())
