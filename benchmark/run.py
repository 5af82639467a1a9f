"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds zerovox_tpu_torch beside benchmark/.
One run: make the weights on the card from the seed (benchmark.weights),
build the program's daemon (zerovox_tpu_torch TTSServer, warm-up on, port 0
on 127.0.0.1) in this process, start the closed-loop clients in a child
process that imports no torch (benchmark.loadgen), let them warm up, then
measure for --seconds.  Set-up (setup_s) is process start to the first
request of the window.  Where a cell's end-to-end metric is read from the
card's activity, CUPTI records the whole window (benchmark.cupti).
--trace 1 runs torch.profiler over a steady sub-window in the middle
(benchmark.trace: the card's activity alone, then a short pass with the CPU
operations that names the idle gaps) and reports the cell's per-layer
metrics instead of its end-to-end ones.  Then the daemon is shut down and
freed, and the plain reference checks the sample of answers the clients kept
(benchmark.check); the numbers compared are printed beside their limits on
standard error and, under "check", last in the result line.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown).  Without a usable
card (torch.cuda.is_available() false, or fewer cards than the cell asks
for) the run prints no result and exits 3; if jax, jaxlib, flax or the JAX
package is loaded when the run ends, it names them on standard error and
exits 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()        # set-up starts here, before the imports

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, cupti, spec, trace, traffic, weights  # noqa: E402

CACHE = ROOT / "benchmark" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "zerovox_tpu")


def set_cache_dirs():
    """Every build and kernel cache of the program in fixed directories
    inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    from zerovox_tpu_torch.utils import compile_cache
    build = CACHE / "build"
    if compile_cache.build_dir() != build:
        compile_cache.enable_compile_cache(str(build))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Recorder:
    """Logs the shapes of each MRF stage call while on: installed in the
    traced run only, around the name the vocoder calls
    (zerovox_tpu_torch.models.hifigan.mrf_stage)."""

    def __init__(self):
        from zerovox_tpu_torch.models import hifigan
        self.mod, self.orig, self.on, self.calls = hifigan, hifigan.mrf_stage, False, []
        orig = self.orig

        def recorded(x, blocks, dilation_sets, kernel_size, **kw):
            y = orig(x, blocks, dilation_sets, kernel_size, **kw)
            if self.on:
                up = kw.get("upsample")
                ks = (tuple(kernel_size[:len(blocks)]) if isinstance(kernel_size, (list, tuple))
                      else kernel_size)
                self.calls.append((x.shape[0], x.shape[1], x.shape[2], y.shape[1], y.shape[2],
                                   [tuple(d) for d in dilation_sets[:len(blocks)]], ks,
                                   None if up is None else up["w"].shape[2],
                                   None if up is None else up["stride"], x.element_size()))
            return y

        hifigan.mrf_stage = recorded

    def remove(self):
        self.mod.mrf_stage = self.orig


def model_config(config: dict):
    from zerovox_tpu_torch.config import ZeroVoxConfig
    return ZeroVoxConfig.from_json(json.dumps(config["model"]))


def counters(server) -> dict:
    return {} if server.batcher is None else {"batcher": server.batcher.snapshot()}


def window_counts(server) -> dict:
    """The batcher's counters and the vocoder's summed frames (needed,
    vocoded) from the program's recorder, read at the window's start and
    after its last answer: what the whole window packed and padded."""
    from zerovox_tpu_torch.utils import profiling
    t = profiling.RECORDER.totals().get("vocoder.frames", {})
    return {**counters(server), "frames": (t.get("a", 0), t.get("b", 0))}


def window_packing(w0: dict, w1: dict) -> dict:
    """Requests per dispatch and frames needed over frames vocoded (%) over
    the window, from two window_counts; None where nothing was counted."""
    b0, b1 = w0.get("batcher"), w1.get("batcher")
    dispatches = None if b0 is None else b1["dispatches"] - b0["dispatches"]
    need, done = (w1["frames"][0] - w0["frames"][0], w1["frames"][1] - w0["frames"][1])
    return {"dispatches": dispatches,
            "mean_batch": (b1["requests"] - b0["requests"]) / dispatches if dispatches else None,
            "vocoder_fill": 100.0 * need / done if done > 0 else None}


def audio_rate(records, t0: float, t1: float, sampling_rate: int):
    """Seconds of speech answered per second by the requests that finished
    in [t0, t1) (host clock); None where none did."""
    done = [r for r in records if r["status"] == 200 and t0 <= r["t_done"] < t1]
    if not done or t1 <= t0:
        return None
    return sum(sum(r["samples"]) for r in done) / sampling_rate / (t1 - t0)


def start_clients(cell, seed, seconds, port, out_dir, model):
    mix_file = out_dir / "mix.json"
    mix_file.write_text(json.dumps(cell.mix))
    m = {k: model[k] for k in ("num_phonemes", "num_puncts")}
    m["d_model"] = model["emb_dim"] + model["punct_emb_dim"]
    child = subprocess.Popen(
        [sys.executable, str(ROOT / "benchmark" / "loadgen.py"), "--mix", str(mix_file),
         "--model", json.dumps(m), "--seed", str(seed), "--seconds", str(seconds),
         "--port", str(port), "--out", str(out_dir), "--sample", str(cell.mix["sample"])],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(ROOT))
    line = child.stdout.readline().strip()
    if line != "READY":
        child.kill()
        child.wait()
        raise RuntimeError(f"load generator did not get ready (said {line!r})")
    return child


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             faults=None) -> dict:
    """One run of `cell`; the result line's object.  `faults`, for the
    harness's own tests: a function called with the built server before
    the clients start, which may break the timed path."""
    import numpy as np
    import torch

    from zerovox_tpu_torch.params import params_from_arrays
    from zerovox_tpu_torch.runtime.server import TTSServer

    from benchmark.reference.model import Reference

    config, mix = cell.config, cell.mix
    model = config["model"]
    precision = model["compute_dtype"]
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    cfg = model_config(config)
    dev = torch.device(device)
    if dev.type == "cuda":
        set_cache_dirs()
        torch.cuda.reset_peak_memory_stats(dev)

    arrays = weights.draw(model, config["assumed"], seed, dev, dtype)
    params = params_from_arrays(arrays, cfg, device=dev)
    server = TTSServer(params, cfg, host="127.0.0.1", port=0, precision=precision,
                       warmup=True, batch_window_ms=mix["batch_window_ms"],
                       chunk_frames=mix["chunk_frames"], overlap=mix["overlap"], device=dev)
    del params
    if faults is not None:
        faults(server)
    server.start()
    # the card's activity over the whole window, for an end-to-end metric
    # read from it (benchmark.cupti); traced runs use the profiler instead
    collector = None
    if dev.type == "cuda" and not traced and any(
            m["source"] == "device_trace" for m in cell.end_to_end):
        collector = cupti.Collector()
    recorder = None
    if traced:
        recorder = Recorder()
        warm = trace.Profiler(dev, cpu=False)   # the profiler's own first start, off the window
        warm.start()
        time.sleep(0.2)
        warm.stop()
    work = Path(tempfile.mkdtemp(prefix="zv-bench-"))
    child = None
    try:
        child = start_clients(cell, seed, seconds, server.address[1], work, model)
        setup_s = time.perf_counter() - T_START
        w0 = window_counts(server)
        if collector is not None:
            collector.start()
        child.stdin.write("GO\n")
        child.stdin.flush()
        t_go = time.monotonic()
        tr = named = None
        if traced:
            # the metrics' pass (the card's activity alone), then a shorter
            # naming pass (CPU operations too) if the window still holds it
            sub = min(3.0, 0.3 * seconds)
            time.sleep(max(0.0, t_go + 0.35 * seconds - time.monotonic()))
            prof = trace.Profiler(dev, cpu=False)
            c0 = counters(server)
            prof.start()
            recorder.on = True
            mono0 = time.monotonic()
            time.sleep(sub)
            mono1 = time.monotonic()
            recorder.on = False
            c1 = counters(server)
            tr = prof.stop()
            costs = {"metrics_pass": prof.costs}
            if time.monotonic() + 1.0 + sub / 3 < t_go + seconds:
                time.sleep(1.0)
                naming = trace.Profiler(dev, cpu=True)
                naming.start()
                time.sleep(sub / 3)
                named = naming.stop()
                costs["naming_pass"] = naming.costs
        if child.wait(timeout=seconds + 600) != 0:
            raise RuntimeError(f"load generator exited {child.returncode}")
        child = None
        w1 = window_counts(server)
        log = json.loads((work / "log.json").read_text())
        t_end = max((r["t_done"] for r in log["records"]), default=log["t_go"])
        with np.load(work / "sample.npz") as z:
            kept = {k: z[k] for k in z.files}
    finally:
        t_read = time.perf_counter()
        if collector is not None:
            collector.stop()
        t_read = time.perf_counter() - t_read
        if child is not None:
            child.kill()
            child.wait()
        if recorder is not None:
            recorder.remove()
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        server.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    del server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    records = log["records"]
    pool = traffic.make_pool(mix, {**model, "d_model": model["emb_dim"] + model["punct_emb_dim"]},
                             seed)
    by_id = {(r["client"], r["k"]): r for r in records}
    answers = []
    for n, s in enumerate(log["sample"]):
        idxs = by_id[(s["client"], s["k"])]["idxs"]
        answers += [(idxs[j], kept[f"a{n}_{j}"]) for j in range(s["n_utts"])]
    t_ref = time.perf_counter()
    ref = Reference(arrays, model, dev)
    refs = {i: ref.synthesize(*pool[i]) for i in sorted({i for i, _ in answers})}
    t_ref = time.perf_counter() - t_ref
    numbers = check.compare(answers, refs, mix, model)
    failed = sum(1 for r in records if r["status"] != 200) + log["hung_clients"]
    numbers["failed"] = failed
    correct, table = check.verdict(numbers, cell.limits)
    margins = {k: min((r["margins"][k] for r in refs.values()), default=None)
               for k in ("duration", "pitch", "energy")}

    def card_busy_s(t0, t1):
        return None if collector is None else collector.busy_s(t0, t1)

    run = SimpleNamespace(records=records, t_go=log["t_go"], setup_s=setup_s,
                          sampling_rate=model["sampling_rate"], card_busy_s=card_busy_s)
    if traced:
        ctx = SimpleNamespace(trace=tr, counters=(c0, c1), mrf_calls=recorder.calls,
                              records=records, window_mono=(mono0, mono1), model=model,
                              precision=precision)
        values = {m["name"]: (m, spec.reader("metrics", m["name"])(ctx)) for m in cell.per_layer}
    else:
        values = {m["name"]: (m, spec.reader("end_to_end", m["name"])(run))
                  for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": m["unit"]} for k, (m, v) in values.items()
               if v is not None}
    result = {"correct": bool(correct), "attempted": len(records), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if traced:
        result["device"]["busy_s"] = trace.busy_ns(tr) / 1e9
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = trace.breakdown(tr, named)
        sr = model["sampling_rate"]
        # the metrics' pass against the window before it: what tracing costs
        costs["audio_s_per_s"] = {"metrics_pass": audio_rate(records, mono0, mono1, sr),
                                  "before": audio_rate(records, log["t_go"] + 1.0, mono0, sr)}
        result["info_trace"] = costs
    hop = model["hop_size"]
    ref_rms = min((float(np.sqrt(np.mean(r["pcm"][:max(1, r["mel_len"]) * hop].astype(np.float64)
                                         ** 2))) for r in refs.values()), default=None)
    span = t_end - log["t_go"]
    busy, copies = (card_busy_s(log["t_go"], t_end),
                    None if collector is None else collector.copy_s(log["t_go"], t_end))
    result["info"] = {"answers_checked": len(answers), "decision_margins": margins,
                      "audio_s_per_s": audio_rate(records, log["t_go"], t_end + 1e-6,
                                                  model["sampling_rate"]),
                      "card_busy_share": None if busy is None or span <= 0 else busy / span,
                      "window": window_packing(w0, w1),
                      "cupti": None if collector is None else {
                          "records": collector.records, "error": collector.error,
                          "read_s": t_read,
                          "copy_share": None if copies is None or span <= 0 else copies / span},
                      "not_compared": {k: v for k, v in numbers.items() if k not in table},
                      "reference_rms_min_lsb": ref_rms, "reference_s": t_ref, "setup_s": setup_s}
    result["check"] = table
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr, flush=True)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr, flush=True)
        return 4
    for name, v in result["check"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
