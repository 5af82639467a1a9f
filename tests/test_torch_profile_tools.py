"""The port's profile_trace, profile_mel and profile_breakdown
(zerovox_tpu_torch/tools/) against the JAX scripts they port: the trace
aggregator on a hand-written Chrome trace, the segments chained against the
port's front and vocoder and the JAX package's, and every segment name the
JAX scripts print in the tools' JSON lines (read from the JAX sources' AST).
TINY geometry, float32, on the CPU."""

import ast
import io
import json
import re
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.models import hifigan as j_hifigan
from zerovox_tpu.models.pipeline import jit_synthesize as j_jit_synthesize

import chip_smoke
from zerovox_tpu_torch import params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.models import fs2_encoder, hifigan, styletts_decoder
from zerovox_tpu_torch.models.pipeline import front
from zerovox_tpu_torch.tools import measure, profile_breakdown, profile_mel, profile_trace

ROOT = Path(__file__).resolve().parents[1]
MEL = dict(atol=5e-3, rtol=1e-3)          # docs/ARCHITECTURE.md §10
WAV = dict(atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------ the trace aggregator

def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _py(name, ts, dur):
    return _x("python_function", name, ts, dur)


def _trace(tmp_path):
    """Two runs: a conv kernel and the MRF kernel each launched twice, one
    memcpy, one memset, host lanes that must not count, and Python frames
    around the launches."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "python"}},
        _x("cpu_op", "aten::conv1d", 0, 900),                    # host lanes
        _x("cuda_runtime", "cudaLaunchKernel", 10, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1010, 5, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernelEx", 30, 5, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernelEx", 1030, 5, correlation=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 50, 5, correlation=5),
        _x("cuda_driver", "cuLaunchKernel", 60, 5, correlation=6),
        _py("/repo/zerovox_tpu_torch/models/hifigan.py(119): vocoder_input", 0, 20),
        _py("/repo/zerovox_tpu_torch/ops/conv.py(106): conv1d", 5, 14),
        _py("/repo/zerovox_tpu_torch/ops/conv.py(88): _product", 8, 10),
        _py("/repo/zerovox_tpu_torch/models/hifigan.py(119): vocoder_input", 1000, 20),
        _py("/repo/zerovox_tpu_torch/ops/conv.py(106): conv1d", 1005, 14),
        _py("/repo/zerovox_tpu_torch/models/hifigan.py(127): vocode_stage", 25, 20),
        _py("/repo/zerovox_tpu_torch/ops/cuda/mrf_stage.py(987): mrf_stage", 28, 15),
        _py("/repo/zerovox_tpu_torch/models/hifigan.py(127): vocode_stage", 1025, 20),
        _py("/repo/zerovox_tpu_torch/ops/cuda/mrf_stage.py(987): mrf_stage", 1028, 15),
        _py("torch/nn/modules/module.py(1500): _call_impl", 48, 10),
        _x("kernel", "cudnn::conv_fwd", 100, 300, tid=20, correlation=1),
        _x("kernel", "cudnn::conv_fwd", 1100, 500, tid=20, correlation=2),
        _x("kernel", "void (anonymous namespace)::mrf_bf16_kernel<256, 2, 4>(Params)", 400,
           2000, tid=20, correlation=3),
        _x("kernel", "void (anonymous namespace)::mrf_bf16_kernel<256, 2, 4>(Params)", 1600,
           2200, tid=20, correlation=4),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 2400, 100, tid=21, correlation=5),
        _x("gpu_memset", "Memset (Device)", 2500, 40, tid=21, correlation=6),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_aggregator_counts_the_cards_events_per_run(tmp_path):
    by_name, by_kind, raw = profile_trace.aggregate_trace(_trace(tmp_path), runs=2)
    mrf = "void (anonymous namespace)::mrf_bf16_kernel<256, 2, 4>(Params)"
    assert by_name == raw == pytest.approx({"cudnn::conv_fwd": 0.4, mrf: 2.1,
                                            "Memcpy DtoH (Device -> Pinned)": 0.05,
                                            "Memset (Device)": 0.02})
    assert by_kind == pytest.approx({"kernel": 2.5, "memcpy": 0.05, "memset": 0.02})
    assert "aten::conv1d" not in by_name and "cudaLaunchKernel" not in by_name


def test_trace_aggregator_attributes_each_event_to_the_ports_source(tmp_path):
    by_name, by_kind, _ = profile_trace.aggregate_trace(_trace(tmp_path), runs=2, attrib=True)
    assert by_name == pytest.approx({
        "models/hifigan.py(119): vocoder_input > ops/conv.py(106): conv1d": 0.4,
        "models/hifigan.py(127): vocode_stage > ops/cuda/mrf_stage.py(987): mrf_stage": 2.1,
        "(unmapped) Memcpy DtoH (Device -> Pinned)": 0.05,
        "(unmapped) Memset (Device)": 0.02})
    assert sum(by_kind.values()) == pytest.approx(sum(by_name.values()))


def test_trace_aggregator_on_the_cpu_counts_top_level_operators(tmp_path):
    events = [_x("cpu_op", "aten::conv1d", 0, 100), _x("cpu_op", "aten::convolution", 10, 80),
              _x("cpu_op", "aten::tanh", 200, 10), _x("cpu_op", "aten::add", 0, 30, tid=2),
              _py("/r/zerovox_tpu_torch/models/hifigan.py(149): vocoder_output", 190, 30)]
    path = tmp_path / "cpu.json"
    path.write_text(json.dumps({"traceEvents": events}))
    by_name, by_kind, _ = profile_trace.aggregate_trace(str(path), runs=1, cuda=False)
    assert by_name == pytest.approx({"aten::conv1d": 0.1, "aten::tanh": 0.01, "aten::add": 0.03})
    assert by_kind == pytest.approx({"cpu_op": 0.14})
    by_name, _, _ = profile_trace.aggregate_trace(str(path), runs=1, attrib=True, cuda=False)
    assert by_name["models/hifigan.py(149): vocoder_output"] == pytest.approx(0.01)


def test_profile_trace_prints_the_jax_scripts_lines():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert profile_trace.main(["--tiny", "--device", "cpu", "--runs", "1", "--top", "5"]) == 0
    lines = buf.getvalue().strip().splitlines()
    head = next(i for i, row in enumerate(lines) if row.startswith("trace: "))
    assert re.match(r"^trace: \d+\.\d{3} ms total device time per run \(B=8\)$", lines[head])
    assert all(re.match(r"^ +\d+\.\d{3} ms  \S", row) for row in lines[head + 1:head + 6])
    line = json.loads(lines[-1])
    assert set(chip_smoke.TOOL_KEYS["profile_trace"]) - {"kernel_ms", "memcpy_ms", "memset_ms"} \
        <= set(line) and line["cpu_op_ms"] == pytest.approx(line["total_ms"])


# ------------------------------------------------------------ the segments

@pytest.fixture(scope="module")
def model():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY), TINY_CONFIG,
                                    device="cpu")
    src, pun, style = measure.draw_inputs(TINY_CONFIG, 2, np.random.default_rng(0))
    ref = j_jit_synthesize(pj, J_TINY)(pj, jnp.asarray(src), jnp.asarray(pun),
                                       jnp.asarray(style))
    return pj, pt, measure.on_device(torch.device("cpu"), src, pun, style), ref


@torch.inference_mode()
def test_profile_mel_segments_chain_to_the_front(model):
    """encoder -> length regulator -> decoder, and inside the decoder the
    ResBlk1d pair, the asr_res branch, the AdaIN stack and the out conv,
    chained on real activations: the port's front (bitwise) and decode, and
    the JAX package's mel."""
    _, pt, (src, pun, style), ref = model
    cfg = TINY_CONFIG
    features, log_dur = fs2_encoder.encode(pt, cfg, src, pun, style)
    hidden, mel_len = profile_mel.length_regulator(cfg, features, log_dur)
    mel = styletts_decoder.decode(pt, cfg, hidden, style)
    want, want_len, _ = front(pt, cfg, src, pun, style, None)
    torch.testing.assert_close(mel, want, rtol=0, atol=0)
    assert torch.equal(mel_len, want_len)
    x = profile_mel.encode_blocks(pt, cfg, hidden)
    asr = profile_mel.asr_branch(pt, cfg, hidden)
    y = profile_mel.out_conv(pt, cfg, profile_mel.adain_stack(pt, cfg, x, asr, style))
    torch.testing.assert_close(y, styletts_decoder.decode(pt, cfg, hidden, style),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(ref.mel_len))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref.mel), **MEL)


@torch.inference_mode()
def test_profile_breakdown_parts_chain_to_the_vocoder(model):
    """The vocoder's parts (input conv, each stage with its upsample, the
    tail), chained on the JAX mel: the port's vocode (bitwise) and the JAX
    package's vocode."""
    pj, pt, _, ref = model
    cfg = TINY_CONFIG
    mel = torch.as_tensor(np.array(ref.mel))
    c = mel
    parts = profile_breakdown.vocoder_parts(pt, cfg)
    for (name, fn), shape in zip(parts, profile_breakdown.part_inputs(pt, cfg, 2)):
        assert tuple(c.shape) == shape, name
        c = fn(c)
    assert len(parts) == len(cfg.upsample_scales) + 2
    torch.testing.assert_close(c[..., 0], hifigan.vocode(pt, cfg, mel), rtol=0, atol=0)
    want = jax.jit(lambda p, m: j_hifigan.vocode(p, J_TINY, m))(pj, jnp.asarray(mel.numpy()))
    np.testing.assert_allclose(c[..., 0].numpy(), np.asarray(want), **WAV)


# ------------------------------------------------------------ the JSON lines

def printed_segments(path):
    """The segment names a JAX profile script prints: the first argument of
    each bench(...) call, and the constant names its summary lines format;
    an f-string as a regular expression (each field one word)."""
    names = []
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "bench":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.append(arg.value.strip())
            else:
                names.append("".join(re.escape(v.value) if isinstance(v, ast.Constant) else r"\S+"
                                     for v in arg.values).replace(r"\ ", " ").strip())
        if isinstance(node, ast.FormattedValue) and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            names.append(node.value.value)
    return names


def _port_name(name):
    """A JAX segment's name in the port: no lane folding (no "folded", no rho)."""
    return name.replace("folded ", "").replace(r" rho=\S+", "")


def _held(names, keys):
    """The JAX names (constants, or patterns: one key each per stage) not
    found among the port's keys."""
    missing = []
    for name in map(_port_name, names):
        if "\\S+" in name:
            hits = [k for k in keys if re.search(name.strip("^$"), k)]
            if len(hits) != 4 and len(hits) != len(TINY_CONFIG.upsample_scales):
                missing.append(name)
        elif name not in keys:
            missing.append(name)
    return missing


def _shape_free(name):
    return re.sub(r"\d+->\d+", "N->N", name)


def _line(main):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["--tiny", "--device", "cpu"]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("tool", ["profile_mel", "profile_breakdown"])
def test_profile_lines_hold_every_segment_the_jax_script_prints(tool):
    names = printed_segments(ROOT / "scripts" / f"{tool}.py")
    assert len(names) >= 7
    # at production geometry: chip_smoke.py's keys for the card's run
    assert not _held(names, chip_smoke.TOOL_KEYS[tool])
    mod = {"profile_mel": profile_mel, "profile_breakdown": profile_breakdown}[tool]
    line = _line(mod.main)
    assert not _held([_shape_free(n) for n in names], [_shape_free(k) for k in line])
    assert set(line["spread_ms"]) <= set(line) and all(v >= 0 for v in line["spread_ms"].values())
    if tool == "profile_breakdown":
        parts = [k for k in line["spread_ms"] if k not in (
            "full synthesize", "encoder+LR+decoder (mel)", "vocoder (full)")]
        assert line["sum of vocoder parts"] == pytest.approx(sum(line[k] for k in parts))
