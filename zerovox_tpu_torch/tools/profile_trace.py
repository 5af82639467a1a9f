"""The card's time per run of the full pipeline by kernel, from a
torch.profiler trace (the port of scripts/profile_trace.py).

    python -m zerovox_tpu_torch.tools.profile_trace [--batch 8] [--f32] [--runs 10]
        [--top 30] [--attrib] [--tiny] [--device cpu]

Runs models.pipeline.synthesize `--runs` times under utils.profiling.trace
(a Chrome trace, <logdir>/trace.json), sums the durations of the card's
events by name (kernels, memcpys and memsets, each kind also summed on its
own; the host's lanes are left out) and prints the time per run of the top
names in the JAX script's lines:

    trace: <total> ms total device time per run (B=<B>)
      <ms> ms  <name>

then a line of the kinds and of the MRF kernel's own events
(mrf_stage_kernel, the f32 mode; mrf_bf16_kernel, the bf16 mode), and one
JSON line of the same numbers.  With --attrib each event is charged to the
port's source instead: the Python frames of zerovox_tpu_torch around the
launch that the trace's correlation id ties to it, as file(line of the
def): function, the innermost one outside ops/ and the op it called.  On the CPU (--device cpu) the CPU is the
device: its top-level operators are the events.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from collections import defaultdict

import numpy as np

from . import measure

_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_PORT_FRAME = re.compile(r"zerovox_tpu_torch/([^()]+\.py)\((\d+)\): (.+)$")
MRF_KERNELS = ("mrf_stage_kernel", "mrf_bf16_kernel")


def _complete(events, cat):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == cat]


def _top_level(ops):
    """The operators of `ops` (one thread's) that no other one encloses."""
    out, end = [], -1.0
    for e in sorted(ops, key=lambda e: (e["ts"], -e.get("dur", 0))):
        if e["ts"] >= end:
            out.append(e)
            end = e["ts"] + e.get("dur", 0)
    return out


def _frames_at(frames, anchors):
    """{key: the port frames open at ts} for anchors (ts, key) on one
    thread: the innermost frame outside ops/ and the ops/ frame it called,
    the op ("models/hifigan.py(95): vocode_stage > ops/cuda/mrf_stage.py(987):
    mrf_stage").  frames are (start, end, label), properly nested."""
    frames = sorted(frames, key=lambda f: (f[0], -f[1]))
    out, stack, i = {}, [], 0
    for ts, key in sorted(anchors):
        while i < len(frames) and frames[i][0] <= ts:
            while stack and stack[-1][1] < frames[i][0]:
                stack.pop()
            stack.append(frames[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        caller = max((j for j, f in enumerate(stack) if not f[2].startswith("ops/")),
                     default=0)
        out[key] = " > ".join(f[2] for f in stack[caller:caller + 2])
    return out


def aggregate_trace(path: str, runs: int, attrib: bool = False, cuda: bool = True):
    """(ms per run by name, ms per run by kind, ms per run by raw event name)
    from a Chrome trace that torch.profiler wrote.  cuda: the device's events
    are the kernel, memcpy and memset lanes (kinds); else the CPU's
    top-level operators (kind "cpu_op").  attrib: names are the port frames
    around each event's launch ("(unmapped) <name>" where there is none)."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    if cuda:
        device = [(e, _KINDS[e["cat"]]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in _KINDS]
    else:
        by_tid = defaultdict(list)
        for e in _complete(events, "cpu_op"):
            by_tid[(e.get("pid"), e.get("tid"))].append(e)
        device = [(e, "cpu_op") for ops in by_tid.values() for e in _top_level(ops)]
    raw, by_kind = defaultdict(float), defaultdict(float, dict.fromkeys(
        _KINDS.values() if cuda else ("cpu_op",), 0.0))
    for e, kind in device:
        raw[e.get("name", "")] += e.get("dur", 0.0)
        by_kind[kind] += e.get("dur", 0.0)
    names = {id(e): e.get("name", "") for e, _ in device}
    if attrib:
        names = _attribute(events, device, cuda)
    by_name = defaultdict(float)
    for e, _ in device:
        by_name[names[id(e)]] += e.get("dur", 0.0)

    def per_run(d):
        return {k: v / runs / 1e3 for k, v in d.items()}
    return per_run(by_name), per_run(by_kind), per_run(raw)


def _attribute(events, device, cuda: bool):
    """{id(event): the port frames around its launch} for device events."""
    anchors = defaultdict(list)          # (pid, tid) -> [(ts, id(event))]
    if cuda:
        launch = {e["args"]["correlation"]: e for cat in _LAUNCH_CATS
                  for e in _complete(events, cat) if "correlation" in e.get("args", {})}
        for e, _ in device:
            host = launch.get(e.get("args", {}).get("correlation"))
            if host is not None:
                anchors[(host.get("pid"), host.get("tid"))].append((host["ts"], id(e)))
    else:
        for e, _ in device:
            anchors[(e.get("pid"), e.get("tid"))].append((e["ts"], id(e)))
    frames = defaultdict(list)
    for e in _complete(events, "python_function"):
        m = _PORT_FRAME.search(e.get("name", ""))
        if m:
            frames[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e.get("dur", 0), f"{m[1]}({m[2]}): {m[3]}"))
    names = {}
    for key, points in anchors.items():
        names.update(_frames_at(frames.get(key, []), points))
    return {id(e): names.get(id(e)) or "(unmapped) " + e.get("name", "")[:60]
            for e, _ in device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--attrib", action="store_true",
                    help="aggregate by the port's source (the Python frames around each "
                         "launch) instead of by kernel name")
    measure.add_device_flags(ap)
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be >= 1")
    dev = measure.start(args.device)

    from ..models.pipeline import load_model
    from ..params import init_params
    from ..utils.profiling import trace
    from .bench import timed_run

    precision = "float32" if args.f32 else "bfloat16"
    cfg = measure.model_config(args.tiny, precision)
    model = load_model(init_params(cfg, seed=0, device=dev), cfg, dev)
    B = args.batch
    run = timed_run(model, cfg, *measure.on_device(
        dev, *measure.draw_inputs(cfg, B, np.random.default_rng(0))))
    run().cpu()
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="zv_trace_") as logdir:
        # per-event durations add up even where runs overlap on the card,
        # so a plain loop of launches will do
        with trace(logdir, with_stack=args.attrib):     # which waits for the card at its end
            for _ in range(args.runs):
                run()
        agg, kinds, raw = aggregate_trace(f"{logdir}/trace.json", args.runs,
                                          attrib=args.attrib, cuda=cuda)
    items = sorted(agg.items(), key=lambda kv: -kv[1])
    total = sum(agg.values())
    print(f"trace: {total:.3f} ms total device time per run (B={B})")
    for name, ms in items[:args.top]:
        print(f"  {ms:8.3f} ms  {name[:110]}")
    mrf = {k: v for k, v in raw.items() if any(m in k for m in MRF_KERNELS)}
    print("trace: by kind per run: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                                  sorted(kinds.items()))
          + f"; the MRF kernel {sum(mrf.values()):.3f} ms in {len(mrf)} instance(s) "
          f"[{measure.card_line(dev)}]")
    measure.report_launches("profile_trace", precision)
    print(json.dumps({
        "total_ms": total, "batch": B, "runs": args.runs, "precision": precision,
        "attrib": args.attrib, **{f"{k}_ms": v for k, v in kinds.items()},
        "mrf_kernel_ms": sum(mrf.values()), "mrf_kernel_names": sorted(mrf),
        "top": [[name, ms] for name, ms in items[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
