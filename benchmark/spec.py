"""Finding a cell's parts by name: BENCHMARK.json names a cell, its
configuration file, its traffic mix (benchmark/traffic/<name>.json), its
correctness limits (benchmark/checks/<cell>.json) and its metrics, each a
reader of its own (benchmark/end_to_end/<name>.py, benchmark/metrics/<name>.py).
A later change adds a cell, a mix, a configuration or a metric as new
files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # the configuration file: source, model, assumed, ...
    mix: dict             # the traffic mix
    limits: dict          # the correctness limits
    end_to_end: List[dict]
    per_layer: List[dict]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, bench: dict = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`, a dict of its form)
    with every part it names loaded."""
    b = bench or benchmark(root)
    w = next((w for w in b["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in b["configs"] if c["name"] == w["config"])
    config = json.loads((root / c["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "checks" / f"{name}.json").read_text())
    return Cell(name, int(w["chips"]), config, mix, limits,
                [m for m in b["end_to_end"] if _applies(m, name)],
                [m for m in b["per_layer"] if _applies(m, name)])


def reader(kind: str, name: str) -> Callable:
    """The `read` function of benchmark/<kind>/<name>.py."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
