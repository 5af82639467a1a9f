"""BENCHMARK.json against the benchmark's contract, and the loader that
finds each cell's configuration, traffic mix, limits and metric readers by
name."""

import json
import re

import pytest

from benchmark import spec, weights

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and all(PATH.match(p) for p in B["paths"])
    assert len(B["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                               for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells must fit in 43200 s
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(B)) < 64 * 1024


def test_entries():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    names += [w["name"] for w in B["workloads"]] + [c["name"] for c in B["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    cfg_names = {c["name"] for c in B["configs"]}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfg_names and w["chips"] == 1 and len(w["why"]) <= 200
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:        # each cell listed reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("name", [w["name"] for w in B["workloads"]])
def test_cell_parts_are_found(name):
    c = spec.cell(name)
    assert c.mix["clients"] >= 1 and c.mix["endpoint"] in ("/synthesize", "/batch", "/stream")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for kind, ms in (("end_to_end", c.end_to_end), ("metrics", c.per_layer)):
        assert all(callable(spec.reader(kind, m["name"])) for m in ms)
    assert set(c.limits) <= {"wav_rel_rms", "wav_max_lsb"} and c.limits


def test_every_file_is_named_by_the_benchmark():
    """No reader, mix or limits file lies unused: each is a metric, a
    traffic mix or a cell of BENCHMARK.json."""
    named = {"end_to_end": {m["name"] for m in B["end_to_end"]},
             "metrics": {m["name"] for m in B["per_layer"]},
             "traffic": {w["traffic"] for w in B["workloads"]},
             "checks": {w["name"] for w in B["workloads"]}}
    for kind, names in named.items():
        files = {p.stem for p in (spec.HERE / kind).iterdir() if p.suffix in (".py", ".json")}
        assert files == names, kind


@pytest.mark.parametrize("cfg", [c["file"] for c in B["configs"]])
def test_configuration_files(cfg):
    from zerovox_tpu_torch.config import ZeroVoxConfig
    c = json.loads((spec.ROOT / cfg).read_text())
    base = json.loads(ZeroVoxConfig().to_json())
    # the published widths, nothing reduced: every field as ZeroVoxConfig() has it
    assert {k: v for k, v in c["model"].items() if k != "compute_dtype"} == {
        k: v for k, v in base.items() if k != "compute_dtype"}
    assert c["model"]["compute_dtype"] in ("float32", "bfloat16")
    assert c["source"].startswith("https://")


def test_weights_follow_the_ports_name_map():
    """The benchmark's frozen copy of the GGUF names and shapes equals the
    port's own map, so params_from_arrays takes every array."""
    import numpy as np

    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.params import _draw_shape, _from_draw_layout, gguf_name_map
    cfg = ZeroVoxConfig()
    c = spec.cell("medium-bf16.serve-mixed-c16").config
    ours = {n: shape for n, shape, _ in weights.leaves(c["model"], c["assumed"])}
    theirs = {}
    for path, (name, kind) in gguf_name_map(cfg).items():
        shape = _from_draw_layout(np.zeros(_draw_shape(path, cfg)), kind).shape
        theirs[name] = (shape[1],) if kind == "vp_lin" else shape
    assert ours == theirs
