"""The port's config/GGUF/params layer against the JAX package's.

A GGUF written by either package must load leaf-for-leaf identical in the
other (f32 and Q8_0), the two save_params must write the same bytes, and
init_params must draw bitwise the same weights from the same seed.
"""

import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig


def _assert_same_arrays(a: dict, b: dict):
    assert list(a) == list(b)
    for name in a:
        assert a[name].shape == b[name].shape, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_bitwise(seed):
    pj = jparams.init_params(J_TINY, seed=seed)
    pt = tparams.init_params(TINY_CONFIG, seed=seed, device="cpu")
    _assert_same_arrays(jparams.params_to_arrays(pj, J_TINY),
                        tparams.params_to_arrays(pt, TINY_CONFIG))


def test_tree_paths_match_jax():
    """Same paths, same leaf count; each port leaf is the JAX leaf in the
    GGUF layout (transposed for linear/conv weights)."""
    pj = jparams.init_params(J_TINY, seed=1)
    arrays = jparams.params_to_arrays(pj, J_TINY)
    pt = tparams.params_from_arrays(arrays, TINY_CONFIG, device="cpu")
    jmap = jparams.gguf_name_map(J_TINY)
    tmap = tparams.gguf_name_map(TINY_CONFIG)
    assert list(jmap) == list(tmap)
    assert [v[0] for v in jmap.values()] == [v[0] for v in tmap.values()]
    w_j = np.asarray(pj["vocoder"]["blocks"][2]["convs1"][1]["w"])        # (K, in, out)
    w_t = pt["vocoder"]["blocks"][2]["convs1"][1]["w"].numpy()            # (out, in, K)
    np.testing.assert_array_equal(w_t, w_j.transpose(2, 1, 0))
    l_j = np.asarray(pj["encoder"]["layers"][0]["attn"]["wq"])             # (in, out)
    np.testing.assert_array_equal(pt["encoder"]["layers"][0]["attn"]["wq"].numpy(), l_j.T)


@pytest.mark.parametrize("quantize", [None, "q8_0"])
def test_jax_gguf_loads_identically(tmp_path, quantize):
    path = str(tmp_path / "jax.gguf")
    pj = jparams.init_params(J_TINY, seed=2)
    jparams.save_params(path, pj, J_TINY, quantize=quantize)
    cfg_j, pj2 = jparams.load_params(path)
    cfg_t, pt = tparams.load_params(path, device="cpu")
    assert cfg_t.to_json() == cfg_j.to_json()
    _assert_same_arrays(jparams.params_to_arrays(pj2, cfg_j),
                        tparams.params_to_arrays(pt, cfg_t))
    assert pt["vocoder"]["upsamples"][0]["w"].dtype == torch.float32


@pytest.mark.parametrize("quantize", [None, "q8_0"])
def test_port_gguf_loads_in_jax_and_matches_bytes(tmp_path, quantize):
    """The port's save_params writes the same file as the JAX package's,
    and the JAX loader reads it back to the same leaves."""
    pt = tparams.init_params(TINY_CONFIG, seed=4, device="cpu")
    pj = jparams.init_params(J_TINY, seed=4)
    p_t, p_j = str(tmp_path / "torch.gguf"), str(tmp_path / "jax.gguf")
    tparams.save_params(p_t, pt, TINY_CONFIG, quantize=quantize)
    jparams.save_params(p_j, pj, J_TINY, quantize=quantize)
    with open(p_t, "rb") as f1, open(p_j, "rb") as f2:
        assert f1.read() == f2.read()
    cfg_j, pj2 = jparams.load_params(p_t)
    _, pt2 = tparams.load_params(p_t, device="cpu")
    _assert_same_arrays(jparams.params_to_arrays(pj2, cfg_j),
                        tparams.params_to_arrays(pt2, TINY_CONFIG))


def test_config_gguf_kv_roundtrip():
    cfg = ZeroVoxConfig()
    assert ZeroVoxConfig.from_gguf_kv(cfg.to_gguf_kv()) == cfg
    kv = {cfg.GGUF_CONFIG_KEY: TINY_CONFIG.to_json()}
    assert ZeroVoxConfig.from_gguf_kv(kv) == TINY_CONFIG
    assert ZeroVoxConfig.from_json(TINY_CONFIG.to_json()) == TINY_CONFIG


def test_params_to_device_and_dtype():
    pt = tparams.init_params(TINY_CONFIG, seed=0, device="cpu", dtype=torch.float64)
    leaves = []
    tparams.tree_map(leaves.append, pt)
    assert leaves and all(t.dtype == torch.float64 for t in leaves)
    moved = tparams.params_to_device(pt, "cpu")
    assert moved["vocoder"]["mean"].device.type == "cpu"


def test_bf16_trees_start_from_the_same_weights():
    """The converter carries bf16 trees: params_from_arrays(dtype=bfloat16)
    rounds each f32 array to nearest even (io.gguf.f32_to_bf16_u16's bits),
    as the JAX package's cast_params does, so both packages start from the
    same bf16 values; params_to_arrays widens a bf16 tree back exactly."""
    import jax.numpy as jnp
    from zerovox_tpu.models.pipeline import cast_params as j_cast
    from zerovox_tpu_torch.io.gguf import f32_to_bf16_u16
    from zerovox_tpu_torch.models.pipeline import cast_params
    pj = jparams.init_params(J_TINY, seed=2)
    arrays = jparams.params_to_arrays(pj, J_TINY)
    pt16 = tparams.params_from_arrays(arrays, TINY_CONFIG, device="cpu", dtype=torch.bfloat16)
    back = tparams.params_to_arrays(pt16, TINY_CONFIG)
    widened = jparams.params_to_arrays(
        j_cast(j_cast(pj, jnp.bfloat16), jnp.float32), J_TINY)
    _assert_same_arrays(back, widened)
    name = next(n for n in arrays if arrays[n].ndim == 3)
    bits = (f32_to_bf16_u16(arrays[name]).astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(back[name], bits)
    same = cast_params(tparams.params_from_arrays(arrays, TINY_CONFIG, device="cpu"),
                       torch.bfloat16)
    _assert_same_arrays(tparams.params_to_arrays(same, TINY_CONFIG), back)
