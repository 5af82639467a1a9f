"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the nearest precision below the one the
configuration states, must come out as not correct.

    python3 -m benchmark.control --workload NAME --seeds 11,12,13 [--precision fp8|tf32|float32]

For each seed: the weights and the traffic pool as a run of the cell makes
them, the checked sample as many utterances as a run checks (the mix's
`sample` requests, each of its utterances) with the pool's longest among
them, answered by the reference in `precision` (default: tf32 for a float32
configuration, fp8 for a bfloat16 one) and held against the float32
reference by the cell's own comparison (benchmark.check).  Prints one JSON
line per seed with the numbers beside the cell's limits, then the smallest
reading of each number over the seeds (the upper reading of its limit).
Runs on the card; nothing here is part of a run of the benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, spec, traffic, weights  # noqa: E402

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def readings(cell: spec.Cell, seed: int, precision: str, device) -> dict:
    """The cell's numbers for the reference in `precision` put in the
    program's place, on `seed`."""
    import torch

    from benchmark.reference.model import Reference
    model, mix = cell.config["model"], cell.mix
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[model["compute_dtype"]]
    arrays = weights.draw(model, cell.config["assumed"], seed, device, dtype)
    pool = traffic.make_pool(mix, {**model, "d_model": model["emb_dim"] + model["punct_emb_dim"]},
                             seed)
    n = min(len(pool), mix["sample"] * mix["utterances_per_request"])
    longest = max(range(len(pool)), key=lambda i: len(pool[i].phonemes))
    idxs = sorted(set(range(n)) | {longest})
    ref = Reference(arrays, model, device)
    refs = {i: ref.synthesize(*pool[i]) for i in idxs}
    del ref
    ctl = Reference(arrays, model, device, precision=precision)
    answers = []
    for i in idxs:
        out = ctl.synthesize(*pool[i])
        answers.append((i, out["pcm"][:check.expected_samples(mix, model, out["mel_len"])]))
    numbers = check.compare(answers, refs, mix, model)
    numbers["failed"] = 0
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--precision", default=None, choices=("fp8", "tf32", "float32"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    cell = spec.cell(args.workload)
    precision = args.precision or LOWER[cell.config["model"]["compute_dtype"]]
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    low = {}
    for s in args.seeds.split(","):
        numbers = readings(cell, int(s), precision, dev)
        correct, table = check.verdict(numbers, cell.limits)
        print(json.dumps({"workload": cell.name, "seed": int(s), "precision": precision,
                          "correct": correct, "check": table}), flush=True)
        for k, v in numbers.items():
            low[k] = min(low.get(k, v), v)
    print(json.dumps({"workload": cell.name, "precision": precision, "smallest": low}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
