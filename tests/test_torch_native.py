"""The port's native GGUF/WAV library (zerovox_tpu_torch.io.native) against
the JAX package's native path and the port's own numpy path, on the same
files: the same tensors bit for bit, the same exception types on missing
tensors and on the corrupt and truncated files of tests/test_native.py and
tests/test_gguf_fuzz.py, the same WAV bytes.  The port builds its own copy
of the source into its build directory, never into native/."""

import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from zerovox_tpu.io import native as jnative
from zerovox_tpu.io.wav import write_wav as j_write_wav
import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.io import native
from zerovox_tpu_torch.io.gguf import GGUF_MAGIC, GGMLType, GGUFReader, GGUFWriter
from zerovox_tpu_torch.io.wav import write_wav
from zerovox_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]
HAS_GXX = shutil.which("g++") is not None
FAMILY = (ValueError, KeyError, EOFError)        # the native reader's failures


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """The JAX native test's sample: f32, f16, i32 and a bf16 tensor."""
    rng = np.random.default_rng(0)
    w = GGUFWriter(arch="zerovox-resnet-fs2-styletts")
    w.add_uint32("zerovox-resnet-fs2-styletts.max_seq_len", 64)
    arrays = {"a.f32": rng.normal(size=(5, 7)).astype(np.float32),
              "b.f16": rng.normal(size=(3, 4, 2)).astype(np.float16),
              "c.i32": rng.integers(0, 100, size=(9,)).astype(np.int32)}
    for n, a in arrays.items():
        w.add_tensor(n, a)
    w.add_tensor("d.bf16", rng.normal(size=(4, 4)).astype(np.float32), ggml_type=GGMLType.BF16)
    path = str(tmp_path_factory.mktemp("native") / "x.gguf")
    w.write(path)
    return path, arrays


def test_available_where_gxx_exists():
    """Where g++ exists the library builds, so the native path is known to
    run in these tests (and not silently the numpy one)."""
    if not HAS_GXX:
        pytest.skip("no g++ on this machine")
    assert native.available(), native.build_error
    path = Path(native.get_lib()._name)
    assert path.parent == compile_cache.build_dir()
    assert path.name.startswith("zvnative_") and path.parent != ROOT / "native"
    assert str(path) in compile_cache.loaded()


def test_native_matches_jax_and_numpy(sample):
    if not native.available():
        pytest.skip(native.build_error)
    path, arrays = sample
    with native.NativeGGUF(path) as ng, GGUFReader(path) as pr, jnative.NativeGGUF(path) as jg:
        assert ng.tensor_names() == jg.tensor_names()
        assert set(ng.tensor_names()) == set(pr.tensor_names())
        for name in list(arrays) + ["d.bf16"]:
            for f32 in (False, True):
                got = ng.get(name, as_float32=f32)
                np.testing.assert_array_equal(got, jg.get(name, as_float32=f32))
                np.testing.assert_array_equal(got, pr.get(name, as_float32=f32))
                assert got.dtype == jg.get(name, as_float32=f32).dtype
        with pytest.raises(KeyError):
            ng.get("nonexistent")
        with pytest.raises(KeyError):
            jg.get("nonexistent")


def test_f16_special_values(tmp_path):
    if not native.available():
        pytest.skip(native.build_error)
    vals = np.array([0.0, -0.0, 1.0, -2.5, 6e-8, -6e-8, 65504.0, np.inf, -np.inf, np.nan],
                    dtype=np.float16)
    w = GGUFWriter()
    w.add_tensor("x", vals)
    path = str(tmp_path / "s.gguf")
    w.write(path)
    with native.NativeGGUF(path) as ng, jnative.NativeGGUF(path) as jg:
        got, want = ng.get("x", as_float32=True), jg.get("x", as_float32=True)
    assert got.tobytes() == want.tobytes()            # NaN payloads and signed zeros too
    ref = vals.astype(np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got[~np.isnan(ref)], ref[~np.isnan(ref)])


def _header(n_tensors, n_kv):
    return struct.pack("<IIqq", GGUF_MAGIC, 3, n_tensors, n_kv)


def _corpus(sample_path, tmp_path):
    """The malformed files of tests/test_native.py and tests/test_gguf_fuzz.py."""
    src = open(sample_path, "rb").read()
    data_offset = GGUFReader(sample_path).data_offset
    files = {"corrupt": b"NOTGGUF" + b"\x00" * 100, "half": src[:len(src) // 2],
             "negative": _header(-1, 0) + b"\x00" * 64}
    for cut in (3, 12, 40, data_offset - 1):
        files[f"cut{cut}"] = src[:cut]
    out = {}
    for name, body in files.items():
        p = tmp_path / f"{name}.gguf"
        p.write_bytes(body)
        out[name] = str(p)
    return out


def _outcome(cls, path):
    try:
        reader = cls(path)
        for n in reader.tensor_names():
            reader.get(n)
        reader.close()
        return "ok"
    except Exception as e:           # noqa: BLE001  (the type is what is compared)
        return type(e).__name__


def test_malformed_files_raise_as_jax(sample, tmp_path):
    """Each corrupt or truncated file raises the exception type the JAX
    native reader raises on it, within the sanctioned family."""
    if not native.available():
        pytest.skip(native.build_error)
    for name, path in _corpus(sample[0], tmp_path).items():
        got, want = _outcome(native.NativeGGUF, path), _outcome(jnative.NativeGGUF, path)
        assert got == want, (name, got, want)
        assert got in {e.__name__ for e in FAMILY}, (name, got)


def test_wav_bytes_equal_jax_writer(tmp_path):
    """Clipped, scaled, truncated toward zero: the native writer's bytes are
    the JAX package's (native and numpy) and the port's numpy path's."""
    rng = np.random.default_rng(3)
    wav = np.concatenate([np.sin(np.linspace(0, 100, 4800)) * 0.9,
                          rng.normal(scale=0.7, size=2000), [1.5, -1.5, 1.0, -1.0, 0.0]]
                         ).astype(np.float32)
    paths = {}
    for name, fn, kw in (("port", write_wav, {}), ("port_numpy", write_wav, {"use_native": False}),
                         ("jax", j_write_wav, {}), ("jax_numpy", j_write_wav, {"use_native": False})):
        paths[name] = tmp_path / f"{name}.wav"
        fn(str(paths[name]), wav, 24000, **kw)
    body = paths["port"].read_bytes()
    assert len(body) == 44 + 2 * wav.size
    for name, p in paths.items():
        assert p.read_bytes() == body, name


@pytest.mark.parametrize("quantize", [None, "q8_0"])
def test_load_params_native_and_numpy_agree(tmp_path, quantize):
    """load_params with use_native True and False, and the JAX package's
    load_params, give the same tensors bit for bit; quantized tensors take
    the numpy reader's dequantization either way."""
    pj = jparams.init_params(J_TINY, seed=0)
    path = str(tmp_path / "m.gguf")
    jparams.save_params(path, pj, J_TINY, quantize=quantize)
    _, a = tparams.load_params(path, device="cpu", use_native=True)
    _, b = tparams.load_params(path, device="cpu", use_native=False)
    _, j = jparams.load_params(path, use_native=True)
    ja = {k: np.asarray(v) for k, v in jparams.params_to_arrays(j, J_TINY).items()}
    ta, tb = tparams.params_to_arrays(a, TINY_CONFIG), tparams.params_to_arrays(b, TINY_CONFIG)
    assert ta.keys() == tb.keys() == ja.keys()
    for k in ta:
        assert ta[k].tobytes() == tb[k].tobytes() == ja[k].astype(np.float32).tobytes(), k


def test_without_a_compiler_the_numpy_path_runs(tmp_path, monkeypatch):
    """No g++ (and no build in the build directory): available() is False,
    and load_params and write_wav take their numpy paths."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(compile_cache, "_dir", tmp_path / "empty")
    assert not native.available()
    assert "compiler" in native.build_error
    assert not list((tmp_path / "empty").glob("*.so"))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeGGUF("unused.gguf")
    path = str(tmp_path / "m.gguf")
    tparams.save_params(path, tparams.init_params(TINY_CONFIG, seed=0, device="cpu"), TINY_CONFIG)
    _, p = tparams.load_params(path, device="cpu")
    assert all(torch.isfinite(t).all() for t in tparams.tree_leaves(p))
    wav = np.linspace(-1, 1, 100).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), wav, 24000)
    write_wav(str(tmp_path / "b.wav"), wav, 24000, use_native=False)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
