"""Training: fit() on synthetic data, export to GGUF, reload, synthesize.

The training stack (zerovox_tpu_torch/training/) is ggml-opt's epoch
loop over a sharded train step: masked mel/duration losses (+ optional
multi-resolution STFT through the vocoder's plain stages: the MRF kernel
has no backward), AdamW with LR schedules, gradient accumulation and
checkpoint/resume.  The exported GGUF is the same wire format the
reference consumes, byte for byte what the JAX package's exporter writes
for the same weights.  The standalone CLI wraps exactly this flow:
`python -m zerovox_tpu_torch.training.cli --synthetic 16 --tiny --epochs 2
--export m.gguf` (`--device cpu` on the CPU).
"""

import os

from _common import setup, demo_utterance


def main(argv=None):
    args, cfg, params = setup(argv)
    import numpy as np
    from zerovox_tpu_torch.models.pipeline import load_model, synthesize
    from zerovox_tpu_torch.params import load_params
    from zerovox_tpu_torch.parallel import DATA_AXIS, make_mesh
    from zerovox_tpu_torch.training.checkpoint import export_weights_gguf
    from zerovox_tpu_torch.training.cli import synthetic_dataset
    from zerovox_tpu_torch.training.fit import fit, make_eval_fn
    from zerovox_tpu_torch.training.train import make_sharded_train_step

    # DP over every device present (the CPU, one card or several: the same
    # code; each data row runs its share of the batch and the gradients are
    # added in row order)
    mesh = make_mesh(devices=[args.device]) if args.device.type == "cpu" else make_mesh()
    n_dev = mesh.shape[DATA_AXIS]
    batch = n_dev * -(-4 // n_dev)        # at least 4, a whole number of rows per device
    data = synthetic_dataset(cfg, n=4 * batch, seed=0)
    state, step = make_sharded_train_step(
        cfg, mesh, params, use_stft=False)   # no-STFT: fast demo loss

    state, history = fit(state, step, data, batch_size=batch, epochs=2,
                         val_split=0.25, shuffle=True, silent=True,
                         eval_fn=make_eval_fn(cfg, mesh=mesh, use_stft=False))
    for h in history:
        print(f"epoch {h['epoch']}: train {h['train_loss']:.4f} "
              f"val {h['val_loss']:.4f} ({h['seconds']:.1f}s)")
    if not history[-1]["train_loss"] < history[0]["train_loss"] * 1.5:
        raise RuntimeError(f"the training loss rose: {history}")

    out = os.path.join(args.out_dir, "example04.gguf")
    export_weights_gguf(out, state, cfg)
    print(f"exported {out} ({os.path.getsize(out)} bytes)")

    # reload through the standard loader and synthesize with the result
    cfg2, params2 = load_params(out, device=args.device)
    model = load_model(params2, cfg2, args.device)
    src, pun, style = demo_utterance(cfg2)
    res = synthesize(model.params, cfg2, src, pun, style, device=model.device,
                     packed=model.packed)
    wav = res.wav.cpu().numpy()
    if not np.isfinite(wav).all():
        raise RuntimeError("the reloaded checkpoint synthesizes a non-finite waveform")
    print(f"reloaded checkpoint synthesizes: wav {wav.shape}, finite")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
