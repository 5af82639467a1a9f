"""Multi-device serving: data-parallel AND tensor-parallel meshes.

Pure DP (mesh d,1): TTSEngine(mesh=) splits each batch over the mesh's
data devices, each running the complete local pipeline (the MRF kernel
included) on its rows with no collective; the right topology for a model
that fits on one card.  TP (mesh d,m): TPServingEngine channel-shards the
front and time-shards the vocoder, so ONE utterance spreads across
devices, for checkpoints that outgrow a card's memory.  These are the
CLI's `--serve --mesh 8,1` / `--serve --mesh 2,4` configurations.

One process drives every device of the mesh.  With `--device cpu` the
mesh is the CPU repeated 8 times; on a machine with several cards, every
card; on a machine with one card, that card repeated 4 times: every regime
then computes what it computes on distinct cards, its devices' work run
one after the other, so it shows the regime's numerics, not a speed-up.

Both answers are held against the one-device engine at B=1, at the JAX
example's gates.  A sharded front sums in another order than one device at
B=1 (TP: the row-parallel sums split over the model axis; DP: each device's
slice of the batch at another batch size), so a pitch or energy prediction
within float rounding of a bucket edge can move to the next bucket; the
hold (parallel/bucket_audit.py) names every such move with its prediction
gap, which must be float order (within FLIP_DELTA), and holds that answer
against the one-device back end continuing the sharded front instead.
"""

import time

from _common import setup, demo_utterance


def main(argv=None):
    args, cfg, params = setup(argv)
    import numpy as np
    import torch
    from zerovox_tpu_torch.parallel import make_mesh
    from zerovox_tpu_torch.parallel.bucket_audit import (TP_TOL, audit_fronts, engine_audit,
                                                         engine_fronts, hold_answers)
    from zerovox_tpu_torch.runtime.engine import TTSEngine
    from zerovox_tpu_torch.runtime.tp_engine import TPServingEngine

    if args.device.type == "cpu":
        devices, which = [args.device] * 8, "the CPU repeated 8 times"
    elif torch.cuda.device_count() > 1:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        which = f"{len(devices)} cards"
    else:
        devices = [args.device] * 4
        which = f"one card ({torch.cuda.get_device_name(args.device)}) repeated 4 times"
    n_dev = len(devices)
    mesh = make_mesh(data=n_dev, model=1, devices=devices)
    print(f"devices: {n_dev} ({which}) -> mesh {mesh.shape}")

    engine = TTSEngine(params, cfg, mesh=mesh)
    B = engine.batch_ladder[-1]          # ladder top scales with the mesh
    engine.warmup(batch=B)
    src, pun, style = demo_utterance(cfg, batch=B)
    n = np.full((B,), cfg.max_n_phonemes, np.int32)

    t0 = time.perf_counter()
    wavs, mel_len = engine.synthesize(src, pun, style, n, trim=False)
    wall = (time.perf_counter() - t0) * 1e3
    print(f"B={B} packed dispatch over {n_dev} devices: {wall:.1f} ms "
          f"({wall / B:.2f} ms/utterance); wav[0] {np.asarray(wavs[0]).shape}")

    # row 0 must equal a single-device run of the same utterance:
    # sharding changes placement, never numerics (the JAX gate, atol 5e-5;
    # a bucket moved by float order is named and held on its back end)
    solo = TTSEngine(params, cfg, device=args.device)
    one = tuple(a[:1] for a in (src, pun, style, n))
    w0, _ = solo.synthesize(*one, trim=False)
    audit = audit_fronts(cfg, solo.model, engine_fronts(cfg, engine, (src, pun, style, n))[:1],
                         engine_fronts(cfg, solo, one))
    print("DP row 0 against the single-device engine: "
          + hold_answers([wavs[0]], [w0[0]], audit, "DP row 0", "wav",
                         dict(atol=5e-5, rtol=1e-7)))

    # tensor parallelism: one utterance spread across the model axis
    model = min(4, n_dev)
    data = max(1, n_dev // 4)
    tp_mesh = make_mesh(data=data, model=model, devices=devices[:data * model])
    tp = TPServingEngine(params, cfg, tp_mesh)
    tp.warmup(batch=1)
    t0 = time.perf_counter()
    tp_wavs, _ = tp.synthesize(*one, trim=False)
    wall = (time.perf_counter() - t0) * 1e3
    print(f"TP {tp_mesh.shape} B=1 dispatch: {wall:.1f} ms")
    # the JAX gate (atol 2e-4, rtol 1e-3: the sums' float reorder) where
    # every bucket is as on one device; a moved bucket is named and held
    # against the one-device back end on the TP front
    print("TP wav against the single-device engine: "
          + hold_answers([tp_wavs[0]], [w0[0]], engine_audit(cfg, tp, solo, one), "TP wav",
                         "wav", TP_TOL))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
