"""The port's MRF stage (plain version, as the wrappers run it on the CPU)
against the JAX Pallas kernel run in interpret mode at rho=1.

Both sides are f32, so only the summation order differs: atol
1e-4 * max|out|, rtol 1e-4.  The CUDA kernel itself runs on the card only;
chip_smoke.py holds it against mrf_stage_ref there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.ops.pallas.folded_mrf import folded_mrf_stage, mrf_stage_unfolded

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG
from zerovox_tpu_torch.ops.cuda import mrf_stage as ms

DILS = TINY_CONFIG.resblock_dilations
K = TINY_CONFIG.resblock_kernel_size


@pytest.fixture(scope="module")
def weights():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY),
                                    TINY_CONFIG, device="cpu")
    n = TINY_CONFIG.num_resblocks
    return ([pj["vocoder"]["blocks"][j] for j in range(n)],          # stage 0, C=16
            [pt["vocoder"]["blocks"][j] for j in range(n)])


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("L,in_bias,out_leaky", [
    (100, False, None),       # no options; L not a multiple of any tile
    (96, True, None),
    (77, False, 0.1),
    (64, True, 0.01)])
def test_mrf_stage_matches_jax(rng, weights, L, in_bias, out_leaky):
    bj, bt = weights
    x = rng.normal(size=(2, L, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32) if in_bias else None
    ref = folded_mrf_stage(jnp.asarray(x), bj, DILS, K, rho=1,
                           in_bias=None if b is None else jnp.asarray(b),
                           out_leaky=out_leaky)
    got = ms.mrf_stage_ref(torch.from_numpy(x), bt, DILS, K,
                           in_bias=None if b is None else torch.from_numpy(b),
                           out_leaky=out_leaky)
    _close(got, ref)


@pytest.mark.parametrize("s,Cin,R,in_leaky", [
    (5, 32, 20, None), (5, 32, 23, 0.1), (3, 24, 30, 0.1)])
def test_mrf_stage_upsample_matches_jax(rng, weights, s, Cin, R, in_leaky):
    """The fused upsample as vocode uses it: standard K = 2s geometry,
    upsample bias via in_bias, in_leaky on or off, out_leaky 0.1."""
    bj, bt = weights
    x = rng.normal(size=(2, R, Cin)).astype(np.float32)
    w = (rng.normal(size=(2 * s, Cin, 16)) * 0.2).astype(np.float32)   # JAX flipped HIO
    b = rng.normal(size=(16,)).astype(np.float32)
    pad, opad = s // 2 + s % 2, s % 2
    ref = folded_mrf_stage(
        jnp.asarray(x), bj, DILS, K, rho=1, in_group=s, in_bias=jnp.asarray(b),
        upsample=dict(w=jnp.asarray(w), stride=s, padding=pad,
                      output_padding=opad, rho_in=1, in_leaky=in_leaky),
        out_leaky=0.1)
    got = ms.mrf_stage_ref(
        torch.from_numpy(x), bt, DILS, K,
        upsample=dict(w=torch.from_numpy(w.transpose(2, 1, 0).copy()), stride=s,
                      padding=pad, output_padding=opad),
        in_bias=torch.from_numpy(b), in_leaky=in_leaky, out_leaky=0.1)
    _close(got, ref)


def test_mrf_stage_unfolded_matches_jax(rng, weights):
    bj, bt = weights
    x = rng.normal(size=(1, 120, 16)).astype(np.float32)
    ref = mrf_stage_unfolded(jnp.asarray(x), bj, DILS, K, rho=1, t_blk=32)
    _close(ms.mrf_stage_unfolded(torch.from_numpy(x), bt, DILS, K), ref)


def test_wrappers_take_plain_version_on_cpu(rng, weights):
    """CPU tensors go to mrf_stage_ref and are not counted as launches."""
    _, bt = weights
    x = torch.from_numpy(rng.normal(size=(1, 50, 16)).astype(np.float32))
    n0, u0 = ms.mrf_stage.launches, ms.mrf_stage_unfolded.launches
    a = ms.mrf_stage(x, bt, DILS, K, out_leaky=0.1)
    torch.testing.assert_close(a, ms.mrf_stage_ref(x, bt, DILS, K, out_leaky=0.1),
                               rtol=0, atol=0)
    ms.mrf_stage_unfolded(x, bt, DILS, K)
    assert (ms.mrf_stage.launches, ms.mrf_stage_unfolded.launches) == (n0, u0)
    with pytest.raises(ValueError):
        ms.mrf_stage(x, bt, DILS, K, in_leaky=0.1)      # in_leaky needs upsample


@pytest.mark.parametrize("C,expect_tile", [(256, 42), (128, 106), (64, 234), (32, 490)])
def test_tile_plan_production(C, expect_tile):
    """The production stages' launch geometry: the weight chunks and three
    f32 windows fit the 227 KB a CTA may use, every conv of the chain fits
    one round of 8 warps, and the pre-upsample rows fit the staging buffers."""
    halo = ms.stage_halo(((1, 3, 5),) * 3, 3)
    assert halo == 12
    plan = ms.tile_plan(C, halo, 3, 1, up_cin=2 * C, up_k=10, up_stride=5)
    assert plan.tile == expect_tile
    assert plan.smem <= 232448 and plan.ss % 2 == 1 and C % plan.ch == 0
    warp_tiles = -(-(plan.tile + 2 * halo - 2) // (8 * 32 // plan.wc)) \
        * (C // plan.tn // plan.wc)
    assert warp_tiles <= 8


@pytest.mark.parametrize("C", [6, 2, 1024])
def test_tile_plan_rejects(C):
    with pytest.raises(ValueError):
        ms.tile_plan(C, 12)


def test_pack_stage_layout(rng, weights):
    """pack_stage's kernel layout: conv q of the chain (resblock, dilation,
    convs1 before convs2) at w[q][k][ci][co], and the flipped export
    upsample kernel as PyTorch's unflipped taps at w_up[k][ci][co]."""
    _, bt = weights
    up = torch.from_numpy(rng.normal(size=(16, 32, 10)).astype(np.float32))
    pk = ms.pack_stage(bt, DILS, K, up)
    chain = [blk[cs][d] for j, blk in enumerate(bt) for d in range(len(DILS[j]))
             for cs in ("convs1", "convs2")]
    assert pk.w.shape == (len(chain), K, 16, 16) and pk.b.shape == (len(chain), 16)
    assert pk.w.is_contiguous() and pk.w_up.is_contiguous()
    for q, conv in enumerate(chain):
        for k in range(K):
            torch.testing.assert_close(pk.w[q, k], conv["w"][:, :, k].T, rtol=0, atol=0)
        torch.testing.assert_close(pk.b[q], conv["b"], rtol=0, atol=0)
    for k in range(10):
        torch.testing.assert_close(pk.w_up[k], up[:, :, 9 - k].T, rtol=0, atol=0)
    assert ms.pack_stage(bt, DILS, K).w_up is None
