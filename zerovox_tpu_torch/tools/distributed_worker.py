"""A two-process check of the port's distributed training, and its launcher.

`launch(argv, n)` starts n copies of a command as the processes of one run
(MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK set as torchrun sets them,
on a free loopback port) and waits for them, killing every one when one
does not end in time.

Run as a module, this file is one process of such a run:

    python -m zerovox_tpu_torch.tools.distributed_worker [--device cpu] [--model M]

launched by `launch` (the tests on the CPU, chip_smoke.py on the card).  It
joins the run (initialize_distributed, from the environment), then prints
"CHECK <name> <value>" lines that every process must print alike:
  reduction   a sum across the processes of distinct per-process tensors;
  train_loss  one sharded TINY train step on the pod mesh (data across the
              processes, M model devices in each), its loss;
  params      a checksum of the parameters after that step;
and checks the loss against the same step run in this process alone on the
same pod layout (make_pod_mesh over local devices): within rtol 1e-6 (the
rows' sums are added in another order across processes).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import List, Sequence, Tuple

import numpy as np

LOSS_RTOL = 1e-6


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], n: int = 2, timeout: float = 300, cwd=None,
           env=None) -> List[Tuple[int, str, str]]:
    """Run n processes of `argv` as one distributed run; [(returncode,
    stdout, stderr)] in rank order.  Raises TimeoutError (after killing
    every process) when one has not ended within `timeout` seconds."""
    port = free_port()
    base = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
    procs = [subprocess.Popen(list(argv), env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=cwd)
             for r in range(n)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            out.append((p.returncode, stdout, stderr))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise TimeoutError(f"{' '.join(argv)}: a process of {n} did not end in {timeout} s")
    return out


def tiny_batch(cfg, B: int, seed: int = 0):
    """The same TINY batch in every process (a seeded draw)."""
    from zerovox_tpu_torch.training.train import TrainBatch
    rng = np.random.default_rng(seed)
    P = cfg.max_n_phonemes
    return TrainBatch(
        src_seq=rng.integers(0, cfg.num_phonemes + 1, (B, P)).astype(np.int32),
        puncts=rng.integers(0, cfg.num_puncts + 1, (B, P)).astype(np.int32),
        style_embed=rng.normal(scale=0.1, size=(B, cfg.d_model)).astype(np.float32),
        num_phonemes=np.linspace(P, P // 2, B).astype(np.int32),
        durations=rng.integers(1, 4, (B, P)).astype(np.int32),
        mel_target=rng.normal(size=(B, cfg.max_seq_len, cfg.num_mels)).astype(np.float32),
        wav_target=rng.normal(scale=0.1, size=(B, cfg.wav_len)).astype(np.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--model", type=int, default=1, help="model-axis size in each process")
    args = ap.parse_args(argv)

    import torch
    from zerovox_tpu_torch.config import TINY_CONFIG as cfg
    from zerovox_tpu_torch.parallel import distributed
    from zerovox_tpu_torch.params import init_params, tree_leaves
    from zerovox_tpu_torch.training import make_sharded_train_step

    torch.set_num_threads(1)
    assert distributed.initialize_distributed(device=args.device) is True
    rank, world = distributed.process_index(), distributed.process_count()
    local = distributed.local_devices()
    if args.model > len(local):            # a shared card, or the CPU: repeat it
        local = local * (args.model // len(local))
    try:
        x = (torch.arange(8, dtype=torch.float32) + 100.0 * rank).to(local[0])
        total = float(distributed.all_reduce_sum(x).sum())
        expect = float(sum(np.arange(8).sum() + 100.0 * 8 * r for r in range(world)))
        assert total == expect, (total, expect)
        print(f"CHECK reduction {total}", flush=True)

        pod = distributed.make_pod_mesh(
            hosts=world, model=args.model,
            devices=[distributed.ProcessDevice(p, d) for p in range(world) for d in local]
            if len(local) > len(distributed.local_devices()) else None)
        assert pod.local_rows is not None and len(pod.local_rows) == pod.shape["data"] // world
        params = init_params(cfg, seed=1, device="cpu")
        res = ((256, 30, 120), (128, 15, 60))
        batch = tiny_batch(cfg, 2 * pod.shape["data"])
        state, step = make_sharded_train_step(cfg, pod, params, stft_resolutions=res)
        state, losses = step(state, batch)
        loss = float(losses["total"])
        assert np.isfinite(loss) and state.step == 1
        print(f"CHECK train_loss {loss:.10f}", flush=True)
        checksum = sum(float(t.double().abs().sum()) for t in tree_leaves(state.params))
        print(f"CHECK params {checksum:.10f}", flush=True)

        # the same step in this process alone, every row of the same layout here
        one = distributed.make_pod_mesh(hosts=world, model=args.model,
                                        devices=[d for _ in range(world) for d in local])
        s1, step1 = make_sharded_train_step(cfg, one, params, stft_resolutions=res)
        _, l1 = step1(s1, batch)
        ref = float(l1["total"])
        assert abs(loss - ref) <= LOSS_RTOL * abs(ref), (loss, ref)
        print(f"CHECK inprocess_step mesh={one.shape} within rtol {LOSS_RTOL}", flush=True)
        distributed.barrier()
    finally:
        distributed.shutdown()
    print("CHECK done ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
