"""Dry run of the multi-device regimes at TINY geometry on n devices.

The port's counterpart of __graft_entry__.py's dryrun_multichip: one
sharded training step (make_sharded_train_step on the (data, model) mesh,
or with --hosts N on the pod layout make_pod_mesh gives N hosts, laid out
in this one process), held against the one-device step on the same batch;
one sharded inference per regime (pure DP, TP with the time-sharded
vocoder, the two-stage pipeline, the time-parallel vocoder) and the two
serving engines (the DP TTSEngine over its scaled ladder, the TP engine
with a warm-up and a hot reload), each held against the single-device
pipeline; one OK line per regime.

    python -m zerovox_tpu_torch.tools.dryrun_multichip 4               # the card(s)
    python -m zerovox_tpu_torch.tools.dryrun_multichip 4 --device cpu  # the CPU
    python -m zerovox_tpu_torch.tools.dryrun_multichip 4 --hosts 2 --device cpu

With fewer distinct cards than n (or on the CPU) the mesh is the one device
repeated n times (parallel.make_mesh(devices=...)): the same regimes, their
work run one after the other.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TP_TOL = dict(atol=2e-4, rtol=1e-3)     # the JAX tests' gate for TP against one device
STREAM_TOL = dict(atol=2e-5, rtol=1e-4)


def mesh_devices(n: int, device: str):
    """n distinct CUDA devices where there are that many, else `device`
    (its first card) repeated n times."""
    from zerovox_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


LOSS_RTOL = 1e-5                        # the sharded step's loss against one device's


def dryrun_multichip(n_devices: int, device: str = "cuda", n_hosts: int = 1) -> None:
    from zerovox_tpu_torch.config import TINY_CONFIG as cfg
    from zerovox_tpu_torch.models import hifigan
    from zerovox_tpu_torch.models.pipeline import synthesize
    from zerovox_tpu_torch.params import init_params
    from zerovox_tpu_torch.parallel import (PipelinedTTS, TimeParallelVocoder, make_mesh,
                                            make_pod_mesh, make_sharded_synthesize, shard_batch)
    from zerovox_tpu_torch.training import make_sharded_train_step, make_train_step
    from zerovox_tpu_torch.training.cli import synthetic_dataset
    from zerovox_tpu_torch.runtime.engine import TTSEngine
    from zerovox_tpu_torch.runtime.tp_engine import TPServingEngine

    devices = mesh_devices(n_devices, device)
    model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data = n_devices // model
    params = init_params(cfg, seed=0, device=devices[0])
    B = data * 2
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, cfg.num_phonemes + 1, size=(B, cfg.max_n_phonemes)),
             rng.integers(0, cfg.num_puncts + 1, size=(B, cfg.max_n_phonemes)),
             rng.normal(scale=0.1, size=(B, cfg.d_model)).astype(np.float32),
             np.full((B,), cfg.max_n_phonemes))
    names = []

    if n_hosts > 1:
        mesh = make_pod_mesh(hosts=n_hosts, model=model, devices=devices)
    else:
        mesh = make_mesh(data=data, model=model, devices=devices)
    res = ((256, 30, 120), (128, 15, 60))
    tbatch = synthetic_dataset(cfg, B, seed=0)
    state, step = make_sharded_train_step(cfg, mesh, params, stft_resolutions=res)
    state, losses = step(state, tbatch)
    total = float(losses["total"])
    s1, step1 = make_train_step(cfg, params, device=devices[0], stft_resolutions=res)
    _, l1 = step1(s1, tbatch)
    assert np.isfinite(total) and abs(total - float(l1["total"])) <= LOSS_RTOL * abs(total), \
        f"sharded train step loss {total} against one device's {float(l1['total'])}"
    print(f"dryrun_multichip train step OK: mesh={mesh.shape} hosts={n_hosts} B={B} "
          f"loss={total:.6f} (one device {float(l1['total']):.6f})", flush=True)
    names.append("sharded train step")

    ref = synthesize(params, cfg, *batch, device=devices[0])
    ref_wav = ref.wav.float().cpu().numpy()

    regimes = [("pure-DP", make_mesh(data=n_devices, model=1, devices=devices))]
    if model > 1:
        regimes.append((f"TP{model}+time-sharded", make_mesh(data=data, model=model,
                                                             devices=devices)))
    for name, mesh in regimes:
        sp, fn = make_sharded_synthesize(cfg, mesh, params)
        wav = fn(sp, *shard_batch(batch, mesh)).wav.float().cpu().numpy()
        assert np.isfinite(wav).all(), f"{name}: non-finite wav"
        np.testing.assert_allclose(wav, ref_wav, **TP_TOL)
        print(f"dryrun_multichip inference[{name}] OK: mesh={mesh.shape} wav={wav.shape} "
              f"|wav|max={np.abs(wav).max():.4f}", flush=True)
        names.append(name)

    if n_devices >= 2:
        pipe = PipelinedTTS(params, cfg, front_device=devices[0], back_device=devices[1])
        for wav, _ in pipe.run([batch, batch]):
            np.testing.assert_allclose(wav, ref_wav, **STREAM_TOL)
        print(f"dryrun_multichip inference[PP 2-stage] OK: front={devices[0]} "
              f"back={devices[1]}", flush=True)
        names.append("PP 2-stage")

        mel = torch.as_tensor(rng.normal(size=(1, cfg.max_seq_len, cfg.num_mels)),
                              dtype=torch.float32, device=devices[0])
        full = hifigan.vocode(params, cfg, mel).cpu().numpy()
        tpv = TimeParallelVocoder(params, cfg, devices=devices[:min(4, n_devices)],
                                  chunk_frames=16, overlap=8)
        wav_sp = tpv.vocode(mel)
        nse = min(wav_sp.shape[1], full.shape[1])
        np.testing.assert_allclose(wav_sp[:, :nse], full[:, :nse], **STREAM_TOL)
        print(f"dryrun_multichip inference[time-SP x{len(tpv.devices)}] OK: exact vs "
              f"single-device over {nse} samples", flush=True)
        names.append("time-SP")

    eng = TTSEngine(params, cfg, mel_buckets=(16, 32),
                    mesh=make_mesh(data=n_devices, model=1, devices=devices))
    wavs, mel_len = eng.synthesize_packed(*batch[:3], num_phonemes=batch[3])
    assert len(wavs) == B and all(np.isfinite(w).all() for w in wavs)
    print(f"dryrun_multichip serving-engine[pure-DP] OK: ladder={eng.batch_ladder} B={B} "
          f"mel_len={np.asarray(mel_len).tolist()}", flush=True)
    names.append("DP serving engine")

    if model > 1:
        teng = TPServingEngine(params, cfg, make_mesh(data=data, model=model, devices=devices),
                               batch_ladder=(1, 2))
        teng.warmup(batch=B)
        twavs, tlen = teng.synthesize(*batch[:3], num_phonemes=batch[3])
        assert len(twavs) == B and all(np.isfinite(w).all() for w in twavs)
        teng.reload_params(init_params(cfg, seed=1, device=devices[0]))
        twavs2, _ = teng.synthesize(*batch[:3], num_phonemes=batch[3])
        assert len(twavs2) == B and all(np.isfinite(w).all() for w in twavs2)
        print(f"dryrun_multichip serving-engine[TP{model}] OK: mesh=({data},{model}) "
              f"ladder={teng.batch_ladder} B={B} mel_len={np.asarray(tlen).tolist()} "
              "+ weights hot-reload", flush=True)
        names.append(f"TP{model} serving engine")

    distinct = len(set(devices))
    print(f"dryrun_multichip OK: {n_devices} devices ({distinct} distinct: "
          f"{', '.join(str(d) for d in dict.fromkeys(devices))}), hosts={n_hosts}: "
          + ", ".join(names), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: distinct cards where there are n, else the first "
                         "repeated) or cpu (the CPU repeated)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="lay the training step's mesh out as this many hosts' pod "
                         "(parallel.make_pod_mesh), in this one process")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.hosts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
