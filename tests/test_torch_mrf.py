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


# the production stages: (C, pre-upsample channels, stride, upsample K,
# output rows at B=1 and bucket 256 of 1500 mel frames)
STAGES = [(256, 512, 5, 10, 1280), (128, 256, 5, 10, 6400),
          (64, 128, 4, 8, 25600), (32, 64, 3, 6, 76800)]
PROD_DILS = ((1, 3, 5),) * 3


@pytest.mark.parametrize("C,expect_tile,expect_kc",
                         [(256, 64, 16), (128, 170, 16), (64, 358, 32), (32, 740, 32)])
def test_tile_plan_production(C, expect_tile, expect_kc):
    """The production stages' longest tiles: the weight ring and two f32
    windows fit the 227 KB a CTA may use, the warps' row tiles cover the
    first conv of every resblock, and the pre-upsample rows fit the staging
    window."""
    assert ms.stage_halo(PROD_DILS, 3) == 12
    _, cin, s, k, _ = next(st for st in STAGES if st[0] == C)
    plan = ms.tile_plan(C, PROD_DILS, 3, up_cin=cin, up_k=k, up_stride=s)
    assert (plan.tile, plan.kc, plan.clusters) == (expect_tile, expect_kc, 0)
    assert plan.smem <= 232448 and plan.ss % 4 == 0 and plan.stages >= 3
    assert C % plan.kc == 0 and plan.kc % 8 == 0 and plan.kc > 4
    nt, mt, warps_m = ms.warp_grid(C)
    window = plan.tile + 2 * 12
    assert warps_m * mt * 16 >= window - 2
    assert plan.smem == 4 * (plan.stages * plan.kc * C + 2 * window * plan.ss) \
        + 16 * plan.stages
    assert ((window + k - 2) // s + 2) * cin <= window * plan.ss


@pytest.mark.parametrize("C,cin,s,k,L_out", STAGES)
def test_tile_plan_fills_a_wave_at_the_serving_shape(C, cin, s, k, L_out):
    """B=1 at bucket 256: the grid fills its last wave of 44 clusters of 3
    (132 SMs) to within one cluster, shortening the tile where the longest
    one leaves SMs idle (stage 1: 32 clusters at 40 rows -> 43 at 30)."""
    longest = ms.tile_plan(C, PROD_DILS, 3, cin, k, s)
    plan = ms.tile_plan(C, PROD_DILS, 3, cin, k, s, B=1, L_out=L_out)
    waves = -(-plan.clusters // 44)
    assert waves == -(-(-(-L_out // longest.tile)) // 44)
    assert plan.tile <= longest.tile
    assert plan.clusters * plan.tile >= L_out > (plan.clusters - 1) * plan.tile
    assert waves * 44 - plan.clusters <= 1
    assert plan.clusters * 3 >= 129
    if C == 256:
        assert (longest.tile, plan.tile, plan.clusters) == (64, 30, 43)


def test_tile_plan_batch_and_wave():
    """B=8 at bucket 256 and a card holding fewer clusters at once."""
    plan = ms.tile_plan(256, PROD_DILS, 3, 512, 10, 5, B=8, L_out=1280)
    assert (plan.tile, plan.clusters) == (59, 176)          # 4 full waves of 44
    plan = ms.tile_plan(256, PROD_DILS, 3, 512, 10, 5, B=1, L_out=1280, wave=40)
    assert (plan.tile, plan.clusters) == (32, 40)


@pytest.mark.parametrize("C", [6, 2, 1024])
def test_tile_plan_rejects(C):
    with pytest.raises(ValueError):
        ms.tile_plan(C, PROD_DILS)
    with pytest.raises(ValueError):                       # chunk not dividing C
        ms.tile_plan(256, PROD_DILS, kc=24)
    with pytest.raises(ValueError):                       # ring too deep to leave a tile
        ms.tile_plan(256, PROD_DILS, kc=64, stages=8)
    with pytest.raises(ValueError):                       # no kernel instance for it
        ms.tile_plan(256, PROD_DILS, kc=8)


@pytest.mark.parametrize("C,cin,s,k,L_out,expect", [
    (256, 512, 5, 10, 7500, (49, 16)),      # full length: 39 rows at chunk 32
    (256, 512, 5, 10, 1280, (33, 32)),      # bucket 256: the wave sets the tile
    (128, 256, 5, 10, 6400, (165, 16)),     # bucket 256: one wave, not two of 83 rows
    (64, 128, 4, 8, 25600, (329, 32)),      # bucket 256: 219 rows at chunk 64
    (32, 64, 3, 6, 450000, (722, 32)),      # the warps set the tile
])
def test_tile_plan_chunk_choice(C, cin, s, k, L_out, expect):
    """The chunk (kc input channels) is the largest of the instance's whose
    tile is within a tenth of the longest (an H100 wave: 39 clusters of 3)."""
    def plan(**kw):
        return ms.tile_plan(C, PROD_DILS, 3, cin, k, s, B=1, L_out=L_out, wave=39, **kw)
    tiles = {kc: plan(kc=kc).tile for kc in (16, 32, 64) if kc <= min(C, 8192 // C)}
    best = max(tiles.values())
    assert plan().kc == max(kc for kc, t in tiles.items() if 1.1 * t >= best)
    assert (plan().tile, plan().kc) == expect


def test_aligned_copies_only_misaligned():
    """The kernel reads float4s: a tensor whose data starts off 16 bytes is
    copied, an aligned one passed as it is."""
    t = torch.zeros(64)
    assert ms._aligned(t) is t and ms._aligned(None) is None
    view = t[1:33]
    got = ms._aligned(view)
    assert got is not view and got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_split_tf32(rng):
    """The kernel's operand split: hi has its low 13 mantissa bits zero (a
    TF32 value, and so has lo), and hi + lo is v to within 2^-21 relative."""
    v = torch.from_numpy(np.concatenate([
        rng.normal(size=4000) * 10.0 ** rng.integers(-6, 6, size=4000),
        [1.0, -1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, 3e-30]]).astype(np.float32))
    hi, lo = ms.split_tf32(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - v.double()).abs()
    assert (err <= 2.0 ** -21 * v.double().abs()).all()
    # round to nearest, ties away from zero (cvt.rna)
    assert hi[-3].item() == 1 + 2 ** -10 and hi[-2].item() == 1 + 2 ** -9


def _conv1d_3xtf32(x, w, b=None, stride=1, padding=0, dilation=1):
    """conv1d with every product taken as hi*hi + hi*lo + lo*hi, as the
    kernel's MMAs take it (f32 sums on the CPU)."""
    xh, xl = ms.split_tf32(x)
    wh, wl = ms.split_tf32(w)

    def conv(a, c):
        return _CONV1D(a, c, None, stride=stride, padding=padding, dilation=dilation)
    y = conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    return y if b is None else y + b


_CONV1D = ms.conv1d


@pytest.mark.parametrize("upsample", [False, True])
def test_3xtf32_stage_matches_f32(rng, weights, monkeypatch, upsample):
    """A stage whose every resblock conv runs as the kernel's 3xTF32 products
    stays within 1e-4 * max|out| of the f32 stage (mrf_stage_ref) and of the
    JAX package's f32 stage on the same numpy inputs."""
    bj, bt = weights
    if upsample:
        x = rng.normal(size=(2, 21, 32)).astype(np.float32)
        w = (rng.normal(size=(10, 32, 16)) * 0.2).astype(np.float32)
        b = rng.normal(size=(16,)).astype(np.float32)
        kw = dict(upsample=dict(w=torch.from_numpy(w.transpose(2, 1, 0).copy()), stride=5,
                                padding=3, output_padding=1),
                  in_bias=torch.from_numpy(b), in_leaky=0.1, out_leaky=0.1)
        ref = folded_mrf_stage(
            jnp.asarray(x), bj, DILS, K, rho=1, in_group=5, in_bias=jnp.asarray(b),
            upsample=dict(w=jnp.asarray(w), stride=5, padding=3, output_padding=1,
                          rho_in=1, in_leaky=0.1),
            out_leaky=0.1)
    else:
        x = rng.normal(size=(1, 120, 16)).astype(np.float32)
        kw = {}
        ref = mrf_stage_unfolded(jnp.asarray(x), bj, DILS, K, rho=1, t_blk=32)
    f32 = ms.mrf_stage_ref(torch.from_numpy(x), bt, DILS, K, **kw)
    monkeypatch.setattr(ms, "conv1d", _conv1d_3xtf32)
    got = ms.mrf_stage_ref(torch.from_numpy(x), bt, DILS, K, **kw)
    assert not torch.equal(got, f32)          # the emulation did run
    _close(got, ref)
    torch.testing.assert_close(got, f32, rtol=1e-4, atol=1e-4 * f32.abs().max().item())


def test_pack_stage_layout(rng, weights):
    """pack_stage's kernel layout: conv q of the chain (resblock, dilation,
    convs1 before convs2) at w[q][k][ci][co ^ 8 * (ci % 4)] for C % 32 == 0
    (co in place for the TINY C=16), and the flipped export upsample kernel
    as PyTorch's unflipped taps at w_up[k][ci][co]."""
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

    C = 64                                   # a width the kernel takes: swizzled
    blk = {cs: [{"w": torch.from_numpy(rng.normal(size=(C, C, K)).astype(np.float32)),
                 "b": torch.zeros(C)}] for cs in ("convs1", "convs2")}
    pk = ms.pack_stage([blk], [(1,)], K)
    w = blk["convs2"][0]["w"]
    for ci in (0, 1, 2, 3, 6, 63):
        for co in (0, 5, 8, 31, 40, 63):
            assert pk.w[1, 2, ci, co ^ 8 * (ci % 4)] == w[co, ci, 2]
    torch.testing.assert_close(ms.swizzle_rows(pk.w), torch.stack(
        [blk[cs][0]["w"].permute(2, 1, 0) for cs in ("convs1", "convs2")]), rtol=0, atol=0)


# --------------------------------------------------------------------------
# bf16 mode: bf16 tensors, bf16 dot operands, f32 accumulation and chain state
# --------------------------------------------------------------------------

BF16_ULP = 2.0 ** -8


def _bf16(a):
    """numpy f32 -> torch bf16 (round to nearest even, as jnp's astype)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)


@pytest.fixture(scope="module")
def weights_bf16(weights):
    """Both sides cast their own tree from the same f32 weights (cast_params
    on either side rounds to nearest even, so the bf16 values are equal)."""
    import jax
    from zerovox_tpu_torch.models.pipeline import cast_params
    bj, bt = weights
    bj16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), bj)
    bt16 = cast_params(bt, torch.bfloat16)
    np.testing.assert_array_equal(
        bt16[0]["convs1"][0]["w"].float().numpy().transpose(2, 1, 0),
        np.asarray(bj16[0]["convs1"][0]["w"].astype(jnp.float32)))
    return bj16, bt16


def _close_bf16(got, ref):
    """At most 2 bf16 ulps of each element's magnitude (tests/test_pallas.py's
    yardstick), plus a floor of one ulp at the output's scale: both sides
    sum the same exact products in f32, in another order, so an operand's or
    the result's rounding to bf16 can fall the other way, and an error of
    one ulp of an intermediate does not shrink with a small output element."""
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    assert g.shape == r.shape
    tol = BF16_ULP * (2 * np.maximum(np.abs(r), np.abs(g)) + np.abs(r).max())
    assert np.all(np.abs(g - r) <= tol), float((np.abs(g - r) / tol).max())
    # and most elements are equal or one ulp apart
    assert np.mean(np.abs(g - r) <= BF16_ULP * np.abs(r)) > 0.9


@pytest.mark.parametrize("L,in_bias,out_leaky", [
    (100, False, None), (64, True, 0.01), (77, True, 0.1)])
def test_mrf_stage_bf16_matches_jax(rng, weights_bf16, L, in_bias, out_leaky):
    """The plain bf16 stage against the TPU kernel's dot_bf16 mode (Pallas in
    interpret mode, rho=1) on the same bf16 inputs."""
    bj, bt = weights_bf16
    x = rng.normal(size=(2, L, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32) if in_bias else None
    ref = folded_mrf_stage(jnp.asarray(x).astype(jnp.bfloat16), bj, DILS, K, rho=1,
                           in_bias=None if b is None else jnp.asarray(b).astype(jnp.bfloat16),
                           out_leaky=out_leaky)
    assert ref.dtype == jnp.bfloat16
    got = ms.mrf_stage_ref(_bf16(x), bt, DILS, K,
                           in_bias=None if b is None else _bf16(b), out_leaky=out_leaky)
    _close_bf16(got, ref)


@pytest.mark.parametrize("s,Cin,R,in_leaky", [(5, 32, 23, 0.1), (3, 24, 30, None)])
def test_mrf_stage_bf16_upsample_matches_jax(rng, weights_bf16, s, Cin, R, in_leaky):
    """The fused upsample with in_bias, in_leaky and out_leaky, as vocode
    calls a stage, in bf16."""
    bj, bt = weights_bf16
    x = rng.normal(size=(2, R, Cin)).astype(np.float32)
    w = (rng.normal(size=(2 * s, Cin, 16)) * 0.2).astype(np.float32)   # JAX flipped HIO
    b = rng.normal(size=(16,)).astype(np.float32)
    pad, opad = s // 2 + s % 2, s % 2
    j16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    ref = folded_mrf_stage(
        j16(x), bj, DILS, K, rho=1, in_group=s, in_bias=j16(b),
        upsample=dict(w=j16(w), stride=s, padding=pad, output_padding=opad, rho_in=1,
                      in_leaky=in_leaky),
        out_leaky=0.1)
    got = ms.mrf_stage(
        _bf16(x), bt, DILS, K,
        upsample=dict(w=_bf16(w.transpose(2, 1, 0)), stride=s, padding=pad,
                      output_padding=opad),
        in_bias=_bf16(b), in_leaky=in_leaky, out_leaky=0.1)
    _close_bf16(got, ref)


def test_mrf_stage_unfolded_bf16_matches_jax(rng, weights_bf16):
    """The unfolded entry in bf16 is the bf16 kernel with every option off:
    equal to mrf_stage without options, and held against the TPU kernel's
    dot_bf16 mode at rho=1.  The JAX package's own mrf_stage_unfolded (an
    experiment that no path runs) leaves dot_bf16 off, so its dots take
    unrounded f32 operands: it agrees only to a few bf16 ulps of the
    output's scale (4 are allowed here)."""
    bj, bt = weights_bf16
    x = rng.normal(size=(1, 120, 16)).astype(np.float32)
    got = ms.mrf_stage_unfolded(_bf16(x), bt, DILS, K)
    torch.testing.assert_close(got, ms.mrf_stage(_bf16(x), bt, DILS, K), rtol=0, atol=0)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    _close_bf16(got, folded_mrf_stage(xj, bj, DILS, K, rho=1))
    ref = np.asarray(mrf_stage_unfolded(xj, bj, DILS, K, rho=1, t_blk=32).astype(jnp.float32))
    assert np.abs(got.float().numpy() - ref).max() <= 4 * BF16_ULP * np.abs(ref).max()


def test_bf16_stage_rounds_once(rng, weights_bf16):
    """1/n and out_leaky act on the f32 sum and the result is rounded once:
    the fused out_leaky equals leaky(f32 result) rounded, which a leaky
    applied to the rounded stage output (two roundings) only approaches, to
    2 bf16 ulps of each element (tests/test_pallas.py pins the same order)."""
    from zerovox_tpu_torch.ops import leaky_relu
    _, bt = weights_bf16
    x = _bf16(rng.normal(size=(2, 90, 16)))
    fused = ms.mrf_stage_ref(x, bt, DILS, K, out_leaky=0.1)
    # the unrounded f32 result: the same chain on f32 copies of the bf16
    # values, with each conv's operand rounded as the bf16 mode rounds it
    h = x.float()
    acc = sum(ms.residual_block(h, blk, DILS[j], K) for j, blk in enumerate(bt)) * 0.5
    assert acc.dtype == torch.float32
    torch.testing.assert_close(fused, leaky_relu(acc, 0.1).to(torch.bfloat16), rtol=0, atol=0)
    twice = leaky_relu(ms.mrf_stage_ref(x, bt, DILS, K), 0.1)
    d = (fused.float() - twice.float()).abs()
    ulp = torch.maximum(fused.float().abs(), twice.float().abs()) * BF16_ULP + 1e-9
    assert (d <= 2 * ulp).all() and (d > 0).any()


def test_bf16_operands_are_rounded(rng, weights_bf16):
    """The bf16 stage is not the f32 stage on bf16-valued inputs: each
    conv's operand is rounded after the leaky, which moves the result."""
    from zerovox_tpu_torch.models.pipeline import cast_params
    _, bt = weights_bf16
    x = _bf16(rng.normal(size=(1, 60, 16)))
    got = ms.mrf_stage_ref(x, bt, DILS, K).float()
    exact = ms.mrf_stage_ref(x.float(), cast_params(bt, torch.float32), DILS, K)
    assert not torch.equal(got, exact.to(torch.bfloat16).float())
    torch.testing.assert_close(got, exact, rtol=0, atol=8 * BF16_ULP * exact.abs().max().item())


def test_stage_dtype_mismatch_raises(rng, weights, weights_bf16):
    """One dtype per call, float32 or bfloat16, on the CPU path as on the card's."""
    _, bt = weights
    _, bt16 = weights_bf16
    x = torch.from_numpy(rng.normal(size=(1, 40, 16)).astype(np.float32))
    with pytest.raises(TypeError):
        ms.mrf_stage(x.to(torch.bfloat16), bt, DILS, K)
    with pytest.raises(TypeError):
        ms.mrf_stage(x, bt16, DILS, K)
    with pytest.raises(TypeError):
        ms.mrf_stage_unfolded(x.double(), bt, DILS, K)
    up = dict(w=torch.zeros(16, 32, 10), stride=5, padding=3, output_padding=1)
    with pytest.raises(TypeError):                        # f32 upsample, bf16 stage
        ms.mrf_stage(torch.zeros(1, 8, 32, dtype=torch.bfloat16), bt16, DILS, K, upsample=up)
    with pytest.raises(TypeError):
        ms.pack_stage(bt16, DILS, K, up["w"])


def test_pack_stage_layout_bf16(rng):
    """bf16 weights: conv q at w[q][k][ci // 2][co ^ 8 * (ci // 2 % 4)][ci % 2], a
    32-bit word per pair of input channels whose low half is the even
    channel (one register of the bf16 MMA's B fragment); biases widened to
    f32; the upsample taps stay [k][ci][co] in bf16."""
    C = 64
    blk = {cs: [{"w": _bf16(rng.normal(size=(C, C, K))), "b": _bf16(rng.normal(size=(C,)))}]
           for cs in ("convs1", "convs2")}
    up = _bf16(rng.normal(size=(C, 2 * C, 10)))
    pk = ms.pack_stage([blk], [(1,)], K, up)
    assert pk.w.shape == (2, K, C // 2, C, 2) and pk.w.dtype == torch.bfloat16
    assert pk.w.is_contiguous() and pk.b.dtype == torch.float32
    assert pk.w_up.dtype == torch.bfloat16 and pk.w_up.shape == (10, 2 * C, C)
    for q, cs in enumerate(("convs1", "convs2")):
        w = blk[cs][0]["w"]
        torch.testing.assert_close(pk.b[q], blk[cs][0]["b"].float(), rtol=0, atol=0)
        for ci in (0, 1, 2, 3, 6, 7, 9, 62, 63):
            for co in (0, 5, 8, 31, 40, 63):
                assert pk.w[q, 2, ci // 2, co ^ 8 * (ci // 2 % 4), ci % 2] == w[co, ci, 2]
    # as the kernel reads it: little-endian words, the even channel in the low half
    words = pk.w.view(torch.int32)[..., 0]
    lo = (words[0, 1, 3, 40 ^ 8 * 3] & 0xFFFF).item()
    assert lo == blk["convs1"][0]["w"][40, 6, 1].view(torch.int16).item() & 0xFFFF
    for k in range(10):
        torch.testing.assert_close(pk.w_up[k], up[:, :, 9 - k].T, rtol=0, atol=0)


@pytest.mark.parametrize("C,cin,s,k,L_out", STAGES)
def test_tile_plan_bf16_production(C, cin, s, k, L_out):
    """2-byte weights: chunks hold twice the channels of an f32 chunk of
    their bytes, the f32 windows take a stride of C + 8, everything fits
    232448 bytes, and at the serving shape (B=1, bucket 256) the grid still
    fills its last wave of 44 clusters to within one."""
    nt, mt, warps_m = ms.warp_grid(C)
    longest = ms.tile_plan(C, PROD_DILS, 3, cin, k, s, elem=2)
    assert longest.ss == C + 8 and longest.kc in ms.chunk_channels(nt, 2)
    assert ms.chunk_channels(nt, 2) == tuple(2 * c for c in ms.chunk_channels(nt, 4))
    window = longest.tile + 24
    assert longest.smem == 4 * (longest.stages * longest.kc * C // 2 + 2 * window * longest.ss) \
        + 16 * longest.stages <= 232448
    assert warps_m * mt * 16 >= window - 2 and C % longest.kc == 0
    assert longest.kc * C // 2 <= max(8192, 16 * C)
    assert ((window + k - 2) // s + 2) * cin <= window * longest.ss
    plan = ms.tile_plan(C, PROD_DILS, 3, cin, k, s, B=1, L_out=L_out, elem=2)
    waves = -(-plan.clusters // 44)
    assert plan.tile <= longest.tile and waves * 44 - plan.clusters <= 1
    assert plan.clusters * plan.tile >= L_out > (plan.clusters - 1) * plan.tile
    f32 = ms.tile_plan(C, PROD_DILS, 3, cin, k, s, B=1, L_out=L_out)
    assert -(-f32.clusters // 44) == waves            # no more waves than the f32 plan


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("frames", [96, 80, 44, 17, 1])
def test_tile_plan_streaming_windows(elem, frames):
    """Streaming windows (96: an interior chunk of 64 + 2 x 16; 80: the
    first chunk; 44: the tail 1500 % 64 + 16; down to one frame) give every
    stage a valid plan of one wave of 39 clusters (two at stage 4 of the
    longest window, whose bf16 tile is the shorter): tiles of at least one
    row that cover L_out, pre-upsample rows that fit the staging window,
    shared memory within the limit."""
    L = frames
    for C, cin, s, k, _ in STAGES:
        L *= s
        plan = ms.tile_plan(C, PROD_DILS, 3, cin, k, s, B=1, L_out=L, wave=39, elem=elem)
        window = plan.tile + 24
        assert plan.tile >= 1 and 1 <= plan.clusters <= (78 if (C, frames) == (32, 96) else 39)
        assert plan.clusters * plan.tile >= L > (plan.clusters - 1) * plan.tile
        assert ((window + k - 2) // s + 2) * cin <= window * plan.ss
        assert plan.smem <= 232448
        assert plan.smem == 4 * (plan.stages * plan.kc * C * elem // 4 + 2 * window * plan.ss) \
            + 16 * plan.stages


def test_tile_plan_bf16_rejects():
    with pytest.raises(ValueError):                       # an element size with no kernel mode
        ms.tile_plan(256, PROD_DILS, elem=3)
    with pytest.raises(ValueError):                       # 16 channels: half a word row set
        ms.tile_plan(256, PROD_DILS, kc=16, elem=2)
    with pytest.raises(ValueError):                       # chunk not dividing C
        ms.tile_plan(64, PROD_DILS, kc=128, elem=2)
    assert ms.tile_plan(256, PROD_DILS, kc=32, elem=2).kc == 32


def test_library_builds_once_under_concurrent_first_calls(monkeypatch):
    """Eight threads make the first call of library() together: one of them
    builds, the others wait for it and get the same object (nothing is
    compiled here: the build itself is replaced)."""
    import threading
    import time
    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)                           # an nvcc run takes seconds
        return ms.Library({}, {}, None, "log", 0.2)

    monkeypatch.setattr(ms, "_build_library", fake_build)
    monkeypatch.setattr(ms, "_library", None)
    barrier = threading.Barrier(8)
    got = []

    def first_call():
        barrier.wait(timeout=30)
        got.append(ms.library())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(builds) == 1 and len(got) == 8 and all(g is got[0] for g in got)
    assert ms.library() is got[0] and len(builds) == 1


def test_launch_counts_survive_concurrent_threads(monkeypatch):
    """Launches counted from 8 threads at once lose nothing (the daemon's
    handler threads all launch; an unlocked += would drop counts)."""
    import sys
    import threading
    monkeypatch.setattr(ms.mrf_stage, "launches", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [ms._count_launch(ms.mrf_stage) for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert ms.mrf_stage.launches == 16000


# --------------------------------------------------------------------------
# the repair: each vocoder stage routed by what the kernel takes
# --------------------------------------------------------------------------

def _meta_vocoder(cfg, dtype=torch.float32):
    """The vocoder's tree at cfg's widths as meta tensors (shapes and dtype
    only, nothing computed or built)."""
    def t(*shape):
        return torch.empty(*shape, device="meta", dtype=dtype)
    n_rb = cfg.num_resblocks
    stages = tparams.vocoder_stage_channels(cfg)
    blocks = [{cs: [{"w": t(co, co, cfg.resblock_kernel_size), "b": t(co)}
                    for _ in cfg.resblock_dilations[j]] for cs in ("convs1", "convs2")}
              for _, co in stages for j in range(n_rb)]
    return {"vocoder": {
        "mean": t(cfg.num_mels), "scale": t(cfg.num_mels),
        "input_conv_w": t(cfg.hifigan_channels, cfg.num_mels, cfg.hifigan_kernel_size),
        "input_conv_b": t(cfg.hifigan_channels),
        "upsamples": [{"w": t(co, ci, k), "b": t(co)}
                      for (ci, co), k in zip(stages, cfg.upsample_kernel_sizes)],
        "blocks": blocks,
        "output_conv_w": t(1, stages[-1][1], cfg.hifigan_kernel_size),
        "output_conv_b": t(1)}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocoder_stage_routes(dtype):
    """Every stage of TINY_CONFIG (C = 16, 8, 4) takes the plain route,
    every production stage (C = 256, 128, 64, 32) the kernel, in both
    modes; the kernel's own plan refuses the TINY widths."""
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.models import hifigan
    prod = ZeroVoxConfig()
    assert hifigan.stage_routes(_meta_vocoder(TINY_CONFIG, dtype), TINY_CONFIG) == [False] * 3
    assert hifigan.stage_routes(_meta_vocoder(prod, dtype), prod) == [True] * 4
    for C in (16, 8, 4):
        with pytest.raises(ValueError):
            ms.tile_plan(C, DILS, K, elem=dtype.itemsize)


@pytest.mark.parametrize("C", [384, 96, 1024, 16, 8, 4])
def test_kernel_takes_refuses(C):
    """Widths the kernel's warp grid has no instance for: refused in both
    modes (warp_grid raises for them), as are an even kernel size, more than
    8 resblocks or dilations, and an upsample input of a width that is not
    16-byte groups; production's stages are taken."""
    with pytest.raises(ValueError):
        ms.warp_grid(C)
    for dtype in (torch.float32, torch.bfloat16):
        assert not ms.kernel_takes(C, PROD_DILS, 3, dtype=dtype)
        assert ms.kernel_takes(256, PROD_DILS, 3, 512, 10, 5, dtype=dtype)
    assert not ms.kernel_takes(256, PROD_DILS, 4)
    assert not ms.kernel_takes(256, ((1,),) * 9, 3)
    assert not ms.kernel_takes(256, ((1,) * 9,), 3)
    assert not ms.kernel_takes(256, PROD_DILS, 3, 510, 10, 5)
    assert not ms.kernel_takes(256, PROD_DILS, 3, dtype=torch.float64)


def test_mrf_stage_still_raises_at_an_untaken_geometry(weights):
    """The route is the vocoder's choice: a tensor that is not on the CPU
    (meta here, a card there) reaching mrf_stage at TINY's width still goes
    to the kernel's checks and raises, with no silent plain fallback."""
    _, blocks = weights
    meta = [{cs: [{k: v.to("meta") for k, v in c.items()} for c in b[cs]]
             for cs in ("convs1", "convs2")} for b in blocks]
    x = torch.zeros(1, 12, 16, device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="C in 32/64/128/256/512"):
        ms.mrf_stage(x, meta, DILS, K)
    with torch.no_grad(), pytest.raises(ValueError, match="C in 32/64/128/256/512"):
        ms.mrf_stage_unfolded(x, meta, DILS, K)


def _card(calls):
    """A stand-in for mrf_stage on a card: refuses what _launch would (the
    tile plan of the stage's geometry), records the stage width of every
    call it takes, and computes with the plain version."""
    def stage(x, blocks, dilation_sets, kernel_size, upsample=None, packed=None, **kw):
        C = blocks[0]["convs1"][0]["w"].shape[0]
        up = (x.shape[2], upsample["w"].shape[2], upsample["stride"]) if upsample else ()
        ms.tile_plan(C, dilation_sets[:len(blocks)], kernel_size, *up,
                     elem=x.dtype.itemsize)
        calls.append(C)
        return ms.mrf_stage_ref(x, blocks, dilation_sets, kernel_size, upsample=upsample, **kw)
    return stage


def test_tiny_engine_on_a_card_takes_the_plain_route(rng, monkeypatch):
    """A TINY engine with the kernel's wrapper replaced by a card's (which
    raises for a width it does not take): warm-up and requests run every
    stage through mrf_stage_ref and never reach the kernel, and answer what
    the unpatched engine answers.  With every stage forced onto the kernel
    (the port before the repair), the first vocode raises."""
    from zerovox_tpu_torch.models import hifigan
    from zerovox_tpu_torch.runtime.engine import TTSEngine
    params = tparams.init_params(TINY_CONFIG, seed=0, device="cpu")
    P = TINY_CONFIG.max_n_phonemes
    src = rng.integers(1, TINY_CONFIG.num_phonemes, size=(2, P))
    pun = rng.integers(0, TINY_CONFIG.num_puncts, size=(2, P))
    style = rng.normal(scale=0.1, size=(2, TINY_CONFIG.d_model)).astype(np.float32)
    want = TTSEngine(params, TINY_CONFIG, device="cpu").synthesize(src, pun, style, trim=False)
    kernel, plain = [], []
    monkeypatch.setattr(hifigan, "mrf_stage", _card(kernel))
    ref = hifigan.mrf_stage_ref
    monkeypatch.setattr(hifigan, "mrf_stage_ref",
                        lambda x, b, *a, **kw: plain.append(b[0]["convs1"][0]["w"].shape[0])
                        or ref(x, b, *a, **kw))
    engine = TTSEngine(params, TINY_CONFIG, mel_buckets=(16, 32), device="cpu")
    engine.warmup(batch=2)
    got = engine.synthesize(src, pun, style, trim=False)
    assert kernel == [] and set(plain) == {16, 8, 4}
    assert len(plain) == 3 * (2 * len(engine.mel_buckets) + 1)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(hifigan, "stage_routes", lambda p, cfg: [True] * 3)
    with pytest.raises(ValueError, match="C in 32/64/128/256/512"):
        engine.synthesize(src, pun, style)


def test_production_vocoder_on_a_card_takes_the_kernel(monkeypatch):
    """At production widths (meta tensors: shapes only) every stage goes to
    the kernel's wrapper, in both modes, and none to the plain version."""
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.models import hifigan
    prod = ZeroVoxConfig()
    for dtype in (torch.float32, torch.bfloat16):
        kernel = []
        monkeypatch.setattr(hifigan, "mrf_stage", _card(kernel))
        monkeypatch.setattr(hifigan, "mrf_stage_ref", None)     # never called
        mel = torch.empty(2, 16, prod.num_mels, device="meta", dtype=dtype)
        with torch.no_grad():
            wav = hifigan.vocode(_meta_vocoder(prod, dtype), prod, mel)
        assert kernel == [256, 128, 64, 32] and wav.shape == (2, 16 * prod.hop_size)
        monkeypatch.undo()
