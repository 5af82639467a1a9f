"""The wgmma MRF kernel (zerovox_tpu_torch/csrc/mrf_stage_bf16.cu: the bf16
mode, and the f16-staged mode built from it) without a card: its launch
plan (`bf16_plan`), its weight layout (`pack_stage` on bf16 weights, or
float32 weights under f16_staging: planes of 8 input channels) and a CPU
model of its shared-memory addressing.

The model (`kernel_model`) replays the kernel's loops in numpy: the weight
chunks in stream order, copied from the packed weights as the bulk copies
copy them; every wgmma operand read through the byte address arithmetic of
its no-swizzle descriptor (start, LBO, SBO) from an emulated shared-memory
buffer; the epilogues written back through the kernel's plane and swizzled
h addresses; products summed in float64.  The operand format follows the
packed weights: bf16 planes with bf16 input and output, or f16 planes with
float32 input and output (the f16-staged mode).  It is held against the
plain version (`mrf_stage_ref` on bf16 tensors, or on float32 ones under
f16_staging) at chip_smoke.py's gates (phase 3's bf16 gate, phase 11's f16
ulp gate), at TINY's geometry (at the kernel's smallest width) and at
production widths on a few dozen rows, and the planes it reads are checked
to hold exactly round(leaky(.)) of the window in the operand format.  The
card's own check of the kernel is phases 3 and 11 of chip_smoke.py; the
descriptor semantics the model assumes are what phase 3's wgmma probes
(bf16 and f16) check there."""

import numpy as np
import pytest
import torch

from zerovox_tpu_torch.config import TINY_CONFIG, ZeroVoxConfig
from zerovox_tpu_torch.ops.conv import f16_staging, transpose_out_len
from zerovox_tpu_torch.ops.cuda import mrf_stage as ms

PROD = ZeroVoxConfig()
PROD_DILS = PROD.resblock_dilations
# the production stages: (C, pre-upsample channels, stride, upsample K,
# output rows at B=1 of 1500 mel frames)
STAGES = [(256, 512, 5, 10, 7500), (128, 256, 5, 10, 37500),
          (64, 128, 4, 8, 150000), (32, 64, 3, 6, 450000)]
SMEM_MAX = 232448
WAVE = 44                           # clusters of 3 an H100's 132 SMs hold at once
BF16_ULP = 2.0 ** -8
F16_ULP = 2.0 ** -10


def _cdiv(a, b):
    return -(-a // b)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def _accounting(plan, C, halo=12):
    """The plan's own accounting: shared memory, registers, rows."""
    assert plan.window == plan.tile + 2 * halo and plan.window <= 128 * plan.mt
    assert plan.kb in {256: (16, 64), 128: (32, 128), 64: (64,), 32: (32,)}[C]
    assert C % plan.kb == 0 and plan.stages >= 2
    assert plan.smem == plan.stages * (plan.kb * C * 2 + 16) + plan.buf \
        + 4 * plan.window * C + 4 * C
    assert 2 <= plan.stages <= 16
    # two warpgroups hold every 64-row M-tile of the window: mt tiles of
    # 64 x C f32 a warpgroup, C / 2 accumulators a thread per tile
    acc = plan.mt * C // 2
    assert 2 * plan.mt * 64 >= plan.window and acc in (128, 64)
    # 256 threads at up to 255 registers fit the SM's 65536 (one CTA, 128
    # accumulators); at 64 accumulators two CTAs of up to 128 registers
    # fit, each with half the shared memory (1 KB of each CTA's reserved)
    ctas = 1 if acc == 128 else 2
    assert ctas * 256 * (255 if ctas == 1 else 128) <= 65536
    assert plan.smem <= (SMEM_MAX if ctas == 1 else (233472 - 2 * 1024) // 2)
    # the operand planes: the window's M-tiles, margins of the largest tap shift
    assert plan.margin == 5 and plan.plane_rows == 64 * _cdiv(plan.window, 64) + 10
    assert plan.buf >= plan.plane_rows * C * 2


@pytest.mark.parametrize("C,cin,s,k,L_out", STAGES)
def test_bf16_plan_production(C, cin, s, k, L_out):
    """The production stages: the largest weight chunk of the instances
    (32 KB copies at C=256 and 128), the longest window beside two of them
    (at C <= 64 the accumulators' 32768 / C rows), everything within 232448
    bytes, the pre-upsample rows within the operand buffer, and at full
    length the tile the shortest that needs no more waves of 44 clusters
    than the longest."""
    longest = ms.bf16_plan(C, PROD_DILS, 3, cin, k, s)
    assert longest.kb == max(ms._BF16_KB[C]) and longest.clusters == 0
    assert longest.mt == {256: 1, 128: 2, 64: 4, 32: 4}[C]       # two CTAs an SM at C=32
    assert longest.window == {256: 92, 128: 192, 64: 512, 32: 512}[C]
    if C >= 128:
        assert longest.kb * C * 2 == 32768 and longest.stages == 2
    _accounting(longest, C)
    assert longest.np_rows == k // s + 1 + 64 * _cdiv(_cdiv(longest.window, s), 64)
    assert longest.np_rows * cin * 2 <= longest.buf
    plan = ms.bf16_plan(C, PROD_DILS, 3, cin, k, s, B=1, L_out=L_out, wave=WAVE)
    _accounting(plan, C)
    assert plan.kb == longest.kb == max(ms._BF16_KB[C])
    waves = _cdiv(_cdiv(L_out, longest.tile), WAVE)
    assert _cdiv(plan.clusters, WAVE) == waves and plan.tile <= longest.tile
    assert plan.clusters * plan.tile >= L_out > (plan.clusters - 1) * plan.tile
    assert waves * WAVE - plan.clusters < waves
    # tile_plan's bf16 answer is bf16_plan's
    assert ms.tile_plan(C, PROD_DILS, 3, cin, k, s, B=1, L_out=L_out, wave=WAVE, elem=2) == plan


@pytest.mark.parametrize("frames", [96, 80, 44, 17, 1])
def test_bf16_plan_streaming_windows(frames):
    """Streaming windows (96: an interior chunk of 64 + 2 x 16; 80: the
    first chunk; 44: the tail; down to one frame): every stage one wave of
    at most 44 clusters (88 where two CTAs share an SM), tiles of at least one row covering L_out, the
    shorter window leaving at least the longest window's ring bytes (as
    larger chunks where three of them fit)."""
    L = frames
    for C, cin, s, k, _ in STAGES:
        L *= s
        wave = WAVE * (2 if C == 32 else 1)      # two CTAs an SM at 32 channels
        plan = ms.bf16_plan(C, PROD_DILS, 3, cin, k, s, B=1, L_out=L, wave=wave)
        _accounting(plan, C)
        assert plan.tile >= 1 and 1 <= plan.clusters <= wave
        assert plan.clusters * plan.tile >= L > (plan.clusters - 1) * plan.tile
        longest = ms.bf16_plan(C, PROD_DILS, 3, cin, k, s)
        assert plan.stages * plan.kb >= longest.stages * longest.kb


def test_bf16_plan_batch_and_wave():
    """B=8 at bucket 256 fills whole waves; a card holding fewer clusters at
    once gets shorter tiles; window and stages replace the longest window and
    the ring depth."""
    plan = ms.bf16_plan(256, PROD_DILS, 3, 512, 10, 5, B=8, L_out=1280, wave=WAVE)
    assert (plan.tile, plan.clusters, plan.window, plan.kb) == (59, 176, 83, 64)
    _accounting(plan, 256)
    plan = ms.bf16_plan(256, PROD_DILS, 3, 512, 10, 5, B=1, L_out=1280, wave=40)
    assert (plan.tile, plan.clusters, plan.kb, plan.stages) == (32, 40, 64, 3)
    small = ms.bf16_plan(256, PROD_DILS, 3, 512, 10, 5, B=1, L_out=1280, wave=40, kb=16)
    assert small.kb == 16 and small.stages > plan.stages
    short = ms.bf16_plan(256, PROD_DILS, 3, 512, 10, 5, window=88)
    assert (short.window, short.tile, short.kb) == (88, 64, 64) and short.stages == 2
    assert ms.bf16_plan(256, PROD_DILS, 3, 512, 10, 5, stages=2).stages == 2


@pytest.mark.parametrize("C", [512, 384, 16, 8])
def test_bf16_plan_rejects_widths(C):
    """Widths with no bf16 instance (a 64 x 512 accumulator tile does not fit
    a warpgroup's registers): refused by the plan and by kernel_takes, so the
    vocoder sends such a stage to the plain version."""
    with pytest.raises(ValueError, match="32/64/128/256 in bfloat16"):
        ms.bf16_plan(C, PROD_DILS)
    with pytest.raises(ValueError):
        ms.tile_plan(C, PROD_DILS, elem=2)
    assert not ms.kernel_takes(C, PROD_DILS, 3, dtype=torch.bfloat16)


def test_bf16_plan_rejects_geometry():
    """An upsample whose input channels are not whole weight chunks, or
    whose kernel is not a multiple of its stride; an even kernel size; a
    ring deeper than 16 or shallower than 2 chunks."""
    with pytest.raises(ValueError):
        ms.bf16_plan(256, PROD_DILS, 3, 520, 10, 5)          # 520 % 16
    with pytest.raises(ValueError):
        ms.bf16_plan(256, PROD_DILS, 3, 512, 9, 5)           # k = 9, s = 5
    with pytest.raises(ValueError):
        ms.bf16_plan(256, PROD_DILS, 4)
    with pytest.raises(ValueError):
        ms.bf16_plan(256, PROD_DILS, 3, 512, 10, 5, stages=17)
    with pytest.raises(ValueError):
        ms.bf16_plan(256, PROD_DILS, 3, 512, 10, 5, stages=1)
    # a deep ring is bought with a shorter window
    deep = ms.bf16_plan(256, PROD_DILS, 3, 512, 10, 5, stages=16)
    assert deep.stages == 16 and deep.window < 128 and deep.smem <= SMEM_MAX
    with pytest.raises(ValueError):
        ms.tile_plan(256, PROD_DILS, elem=3)
    assert not ms.kernel_takes(256, PROD_DILS, 3, 520, 10, 5, dtype=torch.bfloat16)
    assert not ms.kernel_takes(256, PROD_DILS, 3, 512, 9, 5, dtype=torch.bfloat16)
    assert ms.kernel_takes(256, PROD_DILS, 3, 512, 10, 5, dtype=torch.bfloat16)


# --------------------------------------------------------------------------
# the pack
# --------------------------------------------------------------------------

def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.normal(scale=scale, size=shape).astype(np.float32)
                            ).to(torch.bfloat16)


def _blocks(rng, C, dils, kr, scale=0.05):
    """bf16 resblocks of C channels, kr one kernel size or one a resblock."""
    return [{cs: [{"w": _bf16(rng, C, C, kj, scale=scale), "b": _bf16(rng, C, scale=0.1)}
                  for _ in ds] for cs in ("convs1", "convs2")}
            for ds, kj in zip(dils, ms.resblock_sizes(kr, len(dils)))]


def test_planes_round_trip(rng):
    """to_planes puts [.., ci, co] at [.., ci // 8, co, ci % 8]; from_planes
    undoes it bit for bit."""
    w = _bf16(rng, 3, 2, 64, 32)
    p = ms.to_planes(w)
    assert p.shape == (3, 2, 8, 32, 8) and p.is_contiguous()
    for ci in (0, 7, 8, 63):
        for co in (0, 5, 31):
            assert p[1, 0, ci // 8, co, ci % 8] == w[1, 0, ci, co]
    assert torch.equal(ms.from_planes(p), w)


@pytest.mark.parametrize("C,cin,k", [(256, 512, 10), (32, 64, 6)])
def test_pack_stage_bf16_planes(rng, C, cin, k):
    """bf16 weights pack as planes of 8 input channels: unpacking gives back
    every conv's taps in chain order and the unflipped upsample taps exactly;
    a weight chunk (one tap, kb consecutive input channels) is kb * C
    contiguous values; biases widened to float32."""
    from zerovox_tpu_torch.ops.conv import unflip_transpose_weight
    dils = ((1, 3), (5,))
    blocks = _blocks(rng, C, dils, 3)
    up = _bf16(rng, C, cin, k)
    pk = ms.pack_stage(blocks, dils, 3, up)
    assert pk.w.shape == (6, 3, C // 8, C, 8) and pk.w.dtype == torch.bfloat16
    assert pk.w_up.shape == (k, cin // 8, C, 8) and pk.b.dtype == torch.float32
    assert pk.w.is_contiguous() and pk.w_up.is_contiguous()
    q = 0
    for j, ds in enumerate(dils):
        for di in range(len(ds)):
            for cs in ("convs1", "convs2"):
                conv = blocks[j][cs][di]
                assert torch.equal(ms.from_planes(pk.w[q]), conv["w"].permute(2, 1, 0))
                assert torch.equal(pk.b[q], conv["b"].float())
                q += 1
    assert torch.equal(ms.from_planes(pk.w_up),
                       unflip_transpose_weight(up).permute(2, 0, 1))
    kb = ms.bf16_plan(C, PROD_DILS).kb
    flat = pk.w.reshape(-1)
    # the last chunk of conv 4's tap 2 (input channels C - kb .. C): plane (ci // 8), row co
    chunk = flat[((4 * 3 + 2) * C + C - kb) * C:][:kb * C].reshape(kb // 8, C, 8)
    w = blocks[1]["convs1"][0]["w"]
    for ci in range(0, kb, 5):
        assert torch.equal(chunk[ci // 8, :, ci % 8], w[:, C - kb + ci, 2])


def test_pack_stage_bf16_refuses_partial_planes(rng):
    blocks = _blocks(rng, 20, ((1,),), 3)
    with pytest.raises(ValueError, match="planes of 8"):
        ms.pack_stage(blocks, ((1,),), 3)


# --------------------------------------------------------------------------
# the CPU model of the kernel's addressing
# --------------------------------------------------------------------------

def _bits(t):
    """A 16-bit tensor as the model stores it in shared memory: bf16 as its
    bits (uint16), f16 as numpy's float16."""
    if t.dtype == torch.float16:
        return t.contiguous().numpy()
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _round_bits(v, op=torch.bfloat16):
    """Float values as operands of type `op` (bf16 or f16), stored as _bits
    stores them, rounded to nearest even through f32 as the kernel rounds its
    f32 values."""
    return _bits(torch.from_numpy(np.asarray(v, np.float32)).to(op))


def _values(bits):
    """The float64 values of stored operands (_bits)."""
    bits = np.asarray(bits)
    if bits.dtype == np.float16:
        return bits.astype(np.float64)
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _leaky(v, slope):
    return np.where(v >= 0, v, v * slope)


def desc_view(mem, start, k_bytes, mn_bytes, rows):
    """The (rows, 16) matrix a no-swizzle K-major wgmma descriptor reads from
    `mem` (shared memory as 16-bit operands, _bits): element (m, k) at byte start + (m % 8) *
    16 + (m // 8) * mn_bytes + (k // 8) * k_bytes + (k % 8) * 2 (core
    matrices of 8 rows x 16 bytes; k_bytes between the k halves, mn_bytes
    between 8-row groups: the kernel's make_desc arguments.  Which of the
    descriptor's LBO and SBO fields holds which is the card's matter, checked
    by chip_smoke.py's wgmma probe)."""
    m = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    addr = start + (m % 8) * 16 + (m // 8) * mn_bytes + (k // 8) * k_bytes + (k % 8) * 2
    assert start % 16 == 0 and (addr >= 0).all() and (addr < 2 * mem.size).all()
    return _values(mem[addr // 2])


def hidx(r, c, C):
    """The h window's swizzled element index (csrc/mrf_stage_bf16.cu hidx)."""
    return r * C + (((c >> 3) ^ (r & 3)) << 3) + (c & 7)


def plane_write(mem, plane_bytes, row0, rows, values):
    """Rows (row0 + i) of every plane: channel c of row r at byte
    (c // 8) * plane_bytes + r * 16 + (c % 8) * 2."""
    n, C = values.shape
    r = (row0 + np.asarray(rows))[:, None]
    c = np.arange(C)[None, :]
    mem[((c // 8) * plane_bytes + r * 16 + (c % 8) * 2) // 2] = values


def kernel_model(x, packed, dils, kr, up, in_bias, in_leaky, out_leaky, plan, checks,
                 h_in=None, h_out=None, h_sum=None, x_out=None, bases=None):
    """csrc/mrf_stage_bf16.cu's launch on the CPU: per cluster (batch row,
    time tile) and CTA (resblock), the weight stream, the descriptors, the
    epilogues and the resblock sum as the kernel runs them, with float64
    sums.  The operands are of the packed weights' type (bf16, or f16 in the
    f16-staged mode), the input and output of x's (bf16, or float32: read
    as it is, written unrounded).  kr: one kernel size, or one per resblock
    (each CTA streams its own resblock's taps from the ragged pack).
    `checks` counts the operand views held against round(leaky(.)) of the
    window.  h_in, h_out: (n_rb, B, L, C) float64 chain states of a stage
    split into launches (ms.stage_launches): each CTA starts from its
    resblock's h_in rows instead of the input, and writes its tile's h into
    h_out instead of taking the resblock sum.  h_sum: (n_sum, B, L, C) the
    final states of resblocks that earlier launches ran, which the sum adds
    first, in order, before the cluster's, scaling by 1 / (n_sum + n_rb).
    x_out: (B, L, C), where rank 0 writes the stage input over its tile.
    bases: each rank's first conv and first tap in the pack (ms.pack_bases;
    by default the launch's resblocks one after another from 0)."""
    B, L_in, Cin = x.shape
    C = packed.b.shape[1]
    op = packed.w.dtype

    def rb(v):
        return _round_bits(v, op)

    n_rb, ks = len(dils), ms.resblock_sizes(kr, len(dils))
    halo = ms.stage_halo(dils, ks)
    kb, mt, W, tile, margin = plan.kb, plan.mt, plan.window, plan.tile, plan.margin
    chunk = kb * C
    pb = plan.plane_rows * 16
    w_flat = _bits(packed.w).reshape(-1)
    bias = packed.b.double().numpy()
    ib = np.zeros(C) if in_bias is None else in_bias.double().numpy()
    xv = x.double().numpy()
    if up is not None:
        s, pad, K_up = up["stride"], up["padding"], packed.w_up.shape[0]
        L_out = transpose_out_len(L_in, s, K_up, pad, up["output_padding"])
        wup_flat = _bits(packed.w_up).reshape(-1)
        npb = plan.np_rows * 16
    else:
        L_out = L_in
    conv_base = np.cumsum([0] + [2 * len(d) for d in dils])
    tap_base = np.cumsum([0] + [2 * len(d) * k for d, k in zip(dils, ks)])   # chunk_src's
    if bases is not None:
        conv_base, tap_base = bases
    y = np.zeros((B, L_out, C))

    def gemm(mem, a_of, n_chunks, weights, src_of, act, n_tiles, plane_bytes, rows_in_plane):
        """acc[j] of the 64-row M-tiles j in `act` over n_chunks chunks:
        a_of(c) is the chunk's A start (bytes), src_of(c) its place in the
        packed `weights`; B read from the chunk as copied into a ring slot.
        As the kernel, every one of the 2 * mt tiles is computed, a tile past
        the n_tiles that hold data at the last of them; only `act`'s are kept."""
        acc = {j: np.zeros((64, C)) for j in act}
        for c in range(n_chunks):
            ring = weights[src_of(c):][:chunk]        # the bulk copy's bytes
            for ks in range(kb // 16):
                bm = desc_view(ring, ks * 2 * C * 16, C * 16, 128, C)
                for j in range(2 * mt):
                    start = a_of(c) + 2 * ks * plane_bytes + 64 * min(j, n_tiles - 1) * 16
                    row = (start % plane_bytes) // 16
                    assert row + 64 <= rows_in_plane      # never into the next plane
                    prod = desc_view(mem, start, plane_bytes, 128, 64) @ bm.T
                    if j in acc:
                        acc[j] += prod
        return acc

    for bi in range(B):
        for ti in range(_cdiv(L_out, tile)):
            t0 = ti * tile
            t_base = t0 - halo
            H = [np.zeros(W * C) for _ in range(n_rb)]
            bufs = [np.zeros(plan.buf // 2, w_flat.dtype) for _ in range(n_rb)]
            rows = np.arange(W)
            valid = (t_base + rows >= 0) & (t_base + rows < L_out)
            cols = np.arange(C)
            hsw = hidx(rows[:, None], cols[None, :], C)          # (W, C) h indices
            if up is not None:
                jlo = (t_base + pad - (K_up - 1)) // s
                j = jlo + np.arange(plan.np_rows)
                pre = np.zeros((plan.np_rows, Cin))
                ok = (j >= 0) & (j < L_in)
                pre[ok] = xv[bi, j[ok]]
                if in_leaky is not None:
                    pre = _leaky(pre, in_leaky)
                for rank in range(n_rb):
                    plane_write(bufs[rank], npb, 0, np.arange(plan.np_rows), rb(pre))
                    for ph in range(rank, s, n_rb):
                        r_ph = (ph - (t_base + pad)) % s
                        n_ph = _cdiv(W - r_ph, s) if r_ph < W else 0
                        base = (t_base + r_ph + pad - ph) // s - jlo
                        act = [jj for jj in range(2 * mt) if 64 * jj < n_ph]
                        nb_up = Cin // kb
                        for m in range(K_up // s):               # each tap's operand view
                            for jj in act:
                                v = desc_view(bufs[rank], (base - m + 64 * jj) * 16, npb, 128, 64)
                                i = np.arange(64 * jj, 64 * jj + 64)
                                q = (t_base + r_ph + s * i + pad) // s - m
                                good = (i < n_ph) & (q >= 0) & (q < L_in)
                                want = xv[bi, q[good], :16]
                                if in_leaky is not None:
                                    want = _leaky(want, in_leaky)
                                np.testing.assert_array_equal(v[good], _values(rb(want)))
                                checks["upsample"] += 1
                        acc = gemm(bufs[rank],
                                   lambda c: ((c % nb_up) * kb // 8) * npb + (base - c // nb_up) * 16,
                                   (K_up // s) * nb_up, wup_flat,
                                   lambda c: ((ph + s * (c // nb_up)) * Cin + (c % nb_up) * kb) * C,
                                   act, max(1, _cdiv(n_ph, 64)), npb, plan.np_rows)
                        for jj, a in acc.items():
                            i = np.arange(64 * jj, 64 * jj + 64)
                            keep = i < n_ph
                            r = r_ph + s * i[keep]
                            v = a[keep] + ib
                            v[~valid[r]] = 0.0
                            for hh in H:
                                hh[hidx(r[:, None], cols[None, :], C)] = v
            elif h_in is not None:
                for rank, hh in enumerate(H):
                    h0 = np.zeros((W, C))
                    h0[valid] = h_in[rank, bi, t_base + rows[valid]]
                    hh[hsw] = h0
            else:
                h0 = np.zeros((W, C))
                h0[valid] = xv[bi, t_base + rows[valid]] + ib
                for hh in H:
                    hh[hsw] = h0
            if x_out is not None:
                for r in range(min(tile, L_out - t0)):
                    x_out[bi, t0 + r] = H[0][hsw[halo + r]]
            for rank in range(n_rb):
                buf, h = bufs[rank], H[rank]
                kr_r = ks[rank]
                half = (kr_r - 1) // 2
                operand = rb(_leaky(h[hsw], 0.1))
                plane_write(buf, pb, margin, rows, operand)
                lo, hi, q = 0, W, conv_base[rank]
                for di, d in enumerate(dils[rank]):
                    for residual, dd in ((False, d), (True, 1)):
                        lo += half * dd
                        hi -= half * dd
                        act = [jj for jj in range(2 * mt) if 64 * jj < hi and 64 * jj + 64 > lo]
                        nb = C // kb
                        if not residual:                 # each tap's operand view, conv1
                            for tap in range(kr_r):
                                for jj in act:
                                    sh = (tap - half) * dd
                                    v = desc_view(buf, (margin + 64 * jj + sh) * 16, pb, 128, 64)
                                    r = 64 * jj + sh + np.arange(64)
                                    inside = (r >= lo - half * dd) & (r < hi + half * dd)
                                    np.testing.assert_array_equal(
                                        v[inside],
                                        _values(rb(_leaky(h[hsw[r[inside], :16]], 0.1))))
                                    checks["conv"] += 1
                        acc = gemm(buf,
                                   lambda c: margin * 16 + ((c % nb) * kb // 8) * pb
                                   + ((c // nb) - half) * dd * 16,
                                   kr_r * nb, w_flat,
                                   lambda c: ((tap_base[rank] + (q - conv_base[rank]) * kr_r
                                               + c // nb) * C + (c % nb) * kb) * C,
                                   act, _cdiv(W, 64), pb, plan.plane_rows)
                        b = bias[q]
                        for jj, a in acc.items():
                            r = 64 * jj + np.arange(64)
                            keep = (r >= lo) & (r < hi)
                            r, v = r[keep], a[keep] + b
                            idx = hsw[r]
                            if residual:
                                hv = np.where(valid[r][:, None], h[idx] + v, 0.0)
                                h[idx] = hv
                                if di + 1 < len(dils[rank]):
                                    plane_write(buf, pb, margin, r, rb(_leaky(hv, 0.1)))
                            else:
                                o = np.where(valid[r][:, None], _leaky(v, 0.1), 0.0)
                                plane_write(buf, pb, margin, r, rb(o))
                        q += 1
            for r in range(tile):
                tg = t0 + r
                if tg >= L_out:
                    continue
                if h_out is not None:
                    for rank, hh in enumerate(H):
                        h_out[rank, bi, tg] = hh[hsw[halo + r]]
                    continue
                terms = [] if h_sum is None else [hs[bi, tg] for hs in h_sum]
                terms += [hh[hsw[halo + r]] for hh in H]
                v = terms[0]
                for t in terms[1:]:
                    v = v + t
                v = v * (1.0 / len(terms))
                if out_leaky is not None:
                    v = _leaky(v, out_leaky)
                y[bi, tg] = v
    return torch.from_numpy(y.astype(np.float32)).to(x.dtype)


def _gate(got, ref):
    """chip_smoke.py's gate of the mode, per element: 2 ulps of its
    magnitude plus one ulp of max|ref|, in bf16 ulps (phase 3) for bf16
    output, in f16 ulps (phase 11's F16_STAGE_ULPS) for the f16-staged
    mode's float32 output; returns the worst fraction of it."""
    ulp = BF16_ULP if got.dtype == torch.bfloat16 else F16_ULP
    got, ref = got.float(), ref.float()
    tol = ulp * (2.0 * ref.abs() + ref.abs().max())
    return ((got - ref).abs() / tol).max().item()


def _weights(rng, *shape, scale=1.0, staged=False):
    """Random values: bf16 tensors, or float32 ones for the f16-staged mode
    (which rounds them to f16 itself)."""
    t = torch.from_numpy(rng.normal(scale=scale, size=shape).astype(np.float32))
    return t if staged else t.to(torch.bfloat16)


def route_model(x, packed, dils, kr, up, in_bias, in_leaky, out_leaky, wave, checks,
                mode="bf16", route_wave=None):
    """The stage as _launch runs it in `mode`: ms.stage_launches' launches
    in order (at B x L_out rows and `route_wave` clusters of every resblock
    a wave; None: the route without a grid, each resblock alone where sizes
    differ), each in kernel_model at its own plan (bf16_plan with `wave`
    clusters a wave) on the whole pack from each rank's ms.pack_bases, the
    f32 states handed on through a float64 scratch of route.slots (B,
    L_out, C) arrays.  Returns the output, each launch's plan and the route."""
    B, L_in, cin = x.shape
    C = packed.b.shape[1]
    L_out = L_in if up is None else transpose_out_len(
        L_in, up["stride"], packed.w_up.shape[0], up["padding"], up["output_padding"])
    ks = ms.resblock_sizes(kr, len(dils))
    upt = (cin, packed.w_up.shape[0], up["stride"]) if up is not None else (0, 0, 1)
    route = ms.stage_launches(C, dils, ks, upt, mode, B, route_wave and L_out, route_wave)
    scratch = np.zeros((route.slots, B, L_out, C))

    def at(slot, n):
        return None if slot < 0 else scratch[slot:slot + n]

    got, plans = None, []
    for ln in route.launches:
        sd, kl = ms.launch_dilations(dils, ks, ln)
        first, n = ln.reads_x, len(ln.blocks)
        upl = up if first else None
        plan = ms.bf16_plan(C, sd, kl, *(upt if upl else (0, 0, 1)), B=B, L_out=L_out, wave=wave)
        got = kernel_model(x if first else torch.zeros(B, L_out, C, dtype=x.dtype),
                           packed._replace(w_up=packed.w_up if upl else None), sd, kl, upl,
                           in_bias if first else None, in_leaky if first else None,
                           out_leaky if ln.h_out < 0 else None, plan, checks,
                           h_in=at(ln.h_in, n), h_out=at(ln.h_out, n),
                           h_sum=at(0, ln.n_sum) if ln.n_sum else None,
                           x_out=scratch[ln.x_out] if ln.x_out >= 0 else None,
                           bases=ms.pack_bases(C, dils, ks, ln, mode))
        plans.append(plan)
    return got, plans, route


def _run_model(rng, C, cin, s, k, dils, kr, L_pre, B, wave, in_leaky, out_leaky,
               staged=False):
    """The model against mrf_stage_ref on one stage with an upsample, every
    launch of its route (route_model): bf16 tensors, or (staged) float32
    ones with both sides under f16_staging; the worst fraction of the
    mode's gate."""
    blocks = [{cs: [{"w": _weights(rng, C, C, kj, scale=0.05, staged=staged),
                     "b": _weights(rng, C, scale=0.1, staged=staged)}
                    for _ in ds] for cs in ("convs1", "convs2")}
              for ds, kj in zip(dils, ms.resblock_sizes(kr, len(dils)))]
    upw = _weights(rng, C, cin, k, scale=0.05, staged=staged)
    up = dict(w=upw, stride=s, padding=s // 2 + s % 2, output_padding=s % 2)
    x = _weights(rng, B, L_pre, cin, scale=2.0 if staged else 1.0, staged=staged)
    in_bias = _weights(rng, C, scale=0.1, staged=staged)
    with f16_staging(staged):
        packed = ms.pack_stage(blocks, dils, kr, upw)
        ref = ms.mrf_stage_ref(x, blocks, dils, kr, upsample=up, in_bias=in_bias,
                               in_leaky=in_leaky, out_leaky=out_leaky)
    assert packed.w.dtype == (torch.float16 if staged else torch.bfloat16)
    L_out = transpose_out_len(L_pre, s, k, up["padding"], up["output_padding"])
    checks = {"conv": 0, "upsample": 0}
    got, plans, _ = route_model(x, packed, dils, kr, up, in_bias, in_leaky, out_leaky, wave,
                                checks, "f16_staged" if staged else "bf16")
    assert got.dtype == x.dtype == ref.dtype
    assert got.shape == ref.shape == (B, L_out, C)
    assert all(_cdiv(L_out, p.tile) > 1 for p in plans)
    assert checks["conv"] > 0 and checks["upsample"] > 0
    return _gate(got, ref)


def test_model_matches_plain_tiny_geometry(rng):
    """TINY's resblocks (dilations (1, 3) twice, k=3) and first upsample
    (s=5, k=10) at the kernel's smallest width, C=32: B=2, 45 output rows
    over several clusters, every option on."""
    worst = _run_model(rng, 32, 64, 5, 10, TINY_CONFIG.resblock_dilations,
                       TINY_CONFIG.resblock_kernel_size, 9, 2, 4, 0.1, 0.1)
    assert worst <= 1.0


@pytest.mark.parametrize("C,cin,s,k,L_pre", [(256, 512, 5, 10, 8), (32, 64, 3, 6, 14)])
def test_model_matches_plain_production(rng, C, cin, s, k, L_pre):
    """Production stages 1 and 4 on a few dozen output rows, two clusters."""
    out_leaky = 0.1 if C == 256 else 0.01
    worst = _run_model(rng, C, cin, s, k, PROD_DILS, 3, L_pre, 1, 2,
                       0.1 if C == 256 else None, out_leaky)
    assert worst <= 1.0


V1_DILS = ((1, 3, 5),) * 3


@pytest.mark.parametrize("C,cin,s,k,L_pre", [(32, 64, 2, 4, 50), (128, 256, 8, 16, 10)])
def test_model_matches_plain_v1_kernel_sizes(rng, C, cin, s, k, L_pre):
    """HiFi-GAN V1's resblocks (kernels 3/7/11, dilations (1, 3, 5) each;
    a 60-row halo together) at its stages 4 and 2: each resblock a launch
    of its own at its own halo and plan (stage_launches: tiles of 168 / 120
    / 72 rows in 192-row windows at C=128), streaming its taps from the
    ragged pack; the first upsamples and hands the stage input on, each
    leaves its final f32 state, the last sums them in rank order; held
    against mrf_stage_ref at phase 3's bf16 gate; B=1, every launch over
    two clusters or more."""
    route = ms.stage_launches(C, V1_DILS, (3, 7, 11), (cin, k, s))
    assert [(ln.blocks, ln.reads_x) for ln in route.launches] == [
        ((0,), True), ((1,), False), ((2,), False)]
    assert route.slots == 3
    worst = _run_model(rng, C, cin, s, k, V1_DILS, (3, 7, 11), L_pre, 1, 2, 0.1 if C == 128
                       else None, 0.1 if C == 128 else 0.01)
    assert worst <= 1.0


def test_model_matches_plain_v1_unfolded(rng):
    """3/7/11 without an upsample (in_bias on the input): each resblock's
    launch reads x itself, nothing handed on but the final states; C=64, 50
    rows over two clusters or more per launch."""
    C, kr = 64, (3, 7, 11)
    blocks = _blocks(rng, C, V1_DILS, kr)
    x = _bf16(rng, 1, 50, C)
    in_bias = _bf16(rng, C, scale=0.1)
    route = ms.stage_launches(C, V1_DILS, kr)
    assert [ln.reads_x for ln in route.launches] == [True] * 3 and route.slots == 2
    packed = ms.pack_stage(blocks, V1_DILS, kr)
    checks = {"conv": 0, "upsample": 0}
    got, plans, _ = route_model(x, packed, V1_DILS, kr, None, in_bias, None, 0.1, 2, checks)
    ref = ms.mrf_stage_ref(x, blocks, V1_DILS, kr, in_bias=in_bias, out_leaky=0.1)
    assert [p.window - p.tile for p in plans] == [24, 72, 120]
    assert all(_cdiv(50, p.tile) > 1 for p in plans) and checks["conv"] > 0
    assert _gate(got, ref) <= 1.0


@pytest.mark.parametrize("together", [False, True], ids=["alone", "one-wave"])
@pytest.mark.parametrize("B,L_pre", [(1, 4), (2, 3)])
def test_model_matches_plain_v1_first_stage(rng, B, L_pre, together):
    """HiFi-GAN V1's first stage (C=256, 3/7/11; no window holds the k=11
    resblock's 60-row halo).  Alone (a long stage): five launches, k=3
    (halo 12) and k=7 (36) one each, k=11 one per dilation slot (halos 10,
    20, 30), its f32 chain state handed between two slots; the first
    upsamples and hands the stage input on, the last takes the resblock
    sum.  In one wave of clusters (a stream window's grid): the three
    resblocks together in three slot launches (halos 10 / 20 / 30), each
    CTA finding its convs in the chain-order pack by ms.pack_bases.  Held
    against mrf_stage_ref at phase 3's bf16 gate, every launch over two
    time tiles or more."""
    C, cin, s, k = 256, 512, 8, 16
    kr = (3, 7, 11)
    blocks = [{cs: [{"w": _weights(rng, C, C, kj, scale=0.05), "b": _weights(rng, C, scale=0.1)}
                    for _ in ds] for cs in ("convs1", "convs2")} for ds, kj in zip(V1_DILS, kr)]
    upw = _weights(rng, C, cin, k, scale=0.05)
    up = dict(w=upw, stride=s, padding=s // 2 + s % 2, output_padding=s % 2)
    x = _weights(rng, B, L_pre, cin)
    in_bias = _weights(rng, C, scale=0.1)
    packed = ms.pack_stage(blocks, V1_DILS, kr, upw)
    ref = ms.mrf_stage_ref(x, blocks, V1_DILS, kr, upsample=up, in_bias=in_bias,
                           in_leaky=0.1, out_leaky=0.1)
    L_out = transpose_out_len(L_pre, s, k, up["padding"], up["output_padding"])
    checks = {"conv": 0, "upsample": 0}
    got, plans, route = route_model(x, packed, V1_DILS, kr, up, in_bias, 0.1, 0.1, 2 * B, checks,
                                    route_wave=1000 if together else None)
    if together:
        assert [(ln.blocks, ln.slots) for ln in route.launches] == [
            ((0, 1, 2), (d, d + 1)) for d in range(3)]
        assert [p.window - p.tile for p in plans] == [20, 40, 60]
    else:
        assert [(ln.blocks, ln.slots) for ln in route.launches] == [
            ((0,), (0, 3)), ((1,), (0, 3)), ((2,), (0, 1)), ((2,), (1, 2)), ((2,), (2, 3))]
        assert [p.window - p.tile for p in plans] == [24, 72, 20, 40, 60]
    assert all(_cdiv(L_out, p.tile) > 1 for p in plans)
    assert checks["conv"] > 0 and checks["upsample"] > 0
    assert got.shape == ref.shape == (B, L_out, C)
    assert _gate(got, ref) <= 1.0


def test_model_matches_plain_unfolded(rng):
    """No upsample (mrf_stage_unfolded's call): the input widened into h,
    C=64, 50 rows over two clusters."""
    C, dils = 64, PROD_DILS
    blocks = _blocks(rng, C, dils, 3)
    x = _bf16(rng, 1, 50, C)
    packed = ms.pack_stage(blocks, dils, 3)
    plan = ms.bf16_plan(C, dils, 3, B=1, L_out=50, wave=2)
    checks = {"conv": 0, "upsample": 0}
    got = kernel_model(x, packed, dils, 3, None, None, None, None, plan, checks)
    ref = ms.mrf_stage_ref(x, blocks, dils, 3)
    assert _cdiv(50, plan.tile) == 2 and checks["conv"] > 0
    assert _gate(got, ref) <= 1.0


def test_model_catches_a_wrong_descriptor(rng, monkeypatch):
    """The model is sensitive to the addressing it checks: with the k and
    row-group offsets of the A descriptors swapped, the operand views no
    longer hold the window."""
    real = desc_view
    monkeypatch.setitem(globals(), "desc_view",
                        lambda mem, start, kb, mn, rows: real(mem, start, mn, kb, rows)
                        if rows == 64 else real(mem, start, kb, mn, rows))
    with pytest.raises(AssertionError):
        _run_model(rng, 32, 64, 3, 6, PROD_DILS, 3, 14, 1, 2, None, 0.01)


# the f16-staged mode: the same design on f16 planes, float32 input and output

def test_staged_model_matches_plain_tiny_geometry(rng):
    """The f16-staged mode at TINY's resblocks and first upsample (C=32, B=2,
    45 output rows over several clusters, every option on) against
    mrf_stage_ref under f16_staging, at phase 11's f16 ulp gate."""
    worst = _run_model(rng, 32, 64, 5, 10, TINY_CONFIG.resblock_dilations,
                       TINY_CONFIG.resblock_kernel_size, 9, 2, 4, 0.1, 0.1, staged=True)
    assert worst <= 1.0


@pytest.mark.parametrize("C,cin,s,k,L_pre", [(256, 512, 5, 10, 8), (32, 64, 3, 6, 14)])
def test_staged_model_matches_plain_production(rng, C, cin, s, k, L_pre):
    """The f16-staged mode at production stages 1 (with in_leaky) and 4
    (without: the pre-upsample rows are rounded all the same) on a few
    dozen output rows, two clusters."""
    out_leaky = 0.1 if C == 256 else 0.01
    worst = _run_model(rng, C, cin, s, k, PROD_DILS, 3, L_pre, 1, 2,
                       0.1 if C == 256 else None, out_leaky, staged=True)
    assert worst <= 1.0


def test_staged_model_matches_plain_unfolded(rng):
    """The f16-staged mode without an upsample (mrf_stage_unfolded's call):
    the float32 input into h unrounded, C=64, 50 rows over two clusters,
    the output float32."""
    C, dils = 64, PROD_DILS
    blocks = [{cs: [{"w": _weights(rng, C, C, 3, scale=0.05, staged=True),
                     "b": _weights(rng, C, scale=0.1, staged=True)}
                    for _ in ds] for cs in ("convs1", "convs2")} for ds in dils]
    x = _weights(rng, 1, 50, C, scale=2.0, staged=True)
    with f16_staging():
        packed = ms.pack_stage(blocks, dils, 3)
        ref = ms.mrf_stage_ref(x, blocks, dils, 3)
    plan = ms.bf16_plan(C, dils, 3, B=1, L_out=50, wave=2)
    checks = {"conv": 0, "upsample": 0}
    got = kernel_model(x, packed, dils, 3, None, None, None, None, plan, checks)
    assert got.dtype == torch.float32 and _cdiv(50, plan.tile) == 2 and checks["conv"] > 0
    assert _gate(got, ref) <= 1.0


def test_staged_model_catches_a_wrong_descriptor(rng, monkeypatch):
    """The model of the f16-staged mode is as sensitive to the addressing:
    with the A descriptors' k and row-group offsets swapped it fails."""
    real = desc_view
    monkeypatch.setitem(globals(), "desc_view",
                        lambda mem, start, kb, mn, rows: real(mem, start, mn, kb, rows)
                        if rows == 64 else real(mem, start, kb, mn, rows))
    with pytest.raises(AssertionError):
        _run_model(rng, 32, 64, 3, 6, PROD_DILS, 3, 14, 1, 2, None, 0.01, staged=True)


# --------------------------------------------------------------------------
# the tools that measure the kernel on a card
# --------------------------------------------------------------------------

def test_ablation_patterns_in_the_sources():
    """Every text substitution of tools/mrf_ablation.py finds its site,
    once, in its mode's source (a silent miss would time the kernel itself
    under an ablation's name)."""
    from zerovox_tpu_torch.tools import mrf_ablation as ab
    for dtype, source in (("float32", ms.SOURCE), ("bfloat16", ms.SOURCE_BF16),
                          ("f16-staged", ms.SOURCE_BF16)):
        text = source.read_text()
        for name, subs in ab.ABLATIONS[dtype].items():
            for old, new in subs:
                assert text.count(old) == 1 and old != new, (dtype, name)


def test_mrf_compare_refuses_a_tree_without_the_package(tmp_path, capsys):
    """tools/mrf_compare.py needs the other checkout's package; its run
    script compiles."""
    from zerovox_tpu_torch.tools import mrf_compare as mc
    assert mc.main(["--other", str(tmp_path)]) == 2
    assert "no zerovox_tpu_torch package" in capsys.readouterr().err
    compile(mc._RUN, "mrf_compare run", "exec")


def test_mrf_compare_sass_matches_modes_and_counts_lines(monkeypatch):
    """tools/mrf_compare.py's machine-code comparison: each mode's library
    of one checkout is held against the same mode's of the other, by the
    mode in the file name; the anonymous namespace's per-file names are
    masked and only lines that differ count."""
    from zerovox_tpu_torch.tools import mrf_compare as mc
    anon = "_GLOBAL__N__{}_17_mrf_stage_bf16_cu_{}15mrf_bf16_kernel"
    code = {"a/mrf_stage_bf16_0123456789ab.so": [anon.format("366e2ed3", "d0be69bc"),
                                                 "IMAD R1, R2", "RET"],
            "b/mrf_stage_bf16_ba9876543210.so": [anon.format("1234abcd", "00aa11bb"),
                                                 "IMAD R1, R2", "RET"],
            "a/mrf_stage_f16_staged_0123456789ab.so": ["HMMA", "RET"],
            "b/mrf_stage_f16_staged_0123456789ac.so": ["WGMMA", "WGMMA", "RET"],
            "b/zvnative_0123456789ab.so": []}
    monkeypatch.setattr(mc, "cuobjdump_sass", lambda lib: "\n".join(code[lib]))
    got = mc.compare_sass({"other": [k for k in code if k.startswith("a/")],
                           "this": [k for k in code if k.startswith("b/")]})
    assert got == {"bf16": dict(other_lines=3, this_lines=3, differing_lines=0),
                   "f16_staged": dict(other_lines=2, this_lines=3, differing_lines=3)}
