"""The arithmetic of K1 (csrc/ncc_fused.cu) and K2 (csrc/sweep.cu), replayed
in PyTorch on the CPU, against their plain versions.

The kernels form each tap's (K1) or sample's (K2) homogeneous coordinates
from products and rows hoisted out of their loops (K1: dj * cyy once per
row of the tap grid; K2: the rows M u once per view), divide (the two
quotients share one refined reciprocal of hz, which gives the divides' own
bits: ``test_shared_reciprocal_quotients_are_the_divides``), sample with
the corner capped at (W - 2, H - 2), blend as the plain version does and
sum the moments with separate multiplies and adds: the replay
(``fast=False``) equals the plain versions bitwise.

The faster arithmetic first tried for the redesign (``fast=True``: FMA
coordinates from the row base, one reciprocal of hz in place of the two
divides, lerp-form blends, FMA moments; an FMA here is a float64 product
and sum rounded once to float32) fits chip_smoke.py's tolerances at 64x96
(K1: median |d| <= 1e-3 and a share <= 1e-3 above 1e-3; K2 the same at
5e-3) but not at the main path's width, 800 pixels, where coordinates have
8x coarser last bits and the NCC's variance (m2 - m^2 at intensities ~128)
amplifies them: the card measured a share of 2.3e-2 for K1 at B=17.  These
tests keep that finding.
"""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from dvpmvs_torch import fmath
from dvpmvs_torch.engine.packing import pack_ctx, pack_parity
from dvpmvs_torch.geometry import stack_cameras
from dvpmvs_torch.kernels import _build, ncc_fused, sweep_fused
from dvpmvs_torch.kernels.ncc import (COST_MAX, _K_MIN_VAR, _TAP_AXIS,
                                      _bilinear_sample_batch,
                                      _center_inview, _grid, _guard,
                                      _ncc_from_moments, build_cost_context,
                                      plane_warp_fields)
from dvpmvs_torch.kernels.sampling import plane_from_normal_depth
from dvpmvs_torch.kernels.sweep import _mean_selected_baseline
from dvpmvs_torch.utils.synthetic import make_scene

torch.set_num_threads(2)
H, W, V, B = 64, 96, 4, 3


def fma(a, b, c):
    """fmaf: a * b + c rounded once to float32."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def rcp(z):
    """__frcp_rn: the correctly rounded float32 reciprocal."""
    return (1.0 / z.double()).float()


def lerp_bilinear(imgs, x, y):
    """The fast arithmetic's border-clamped bilinear sample: imgs
    [V, H, W], x, y [V, ...] -> [V, ...], blended as three lerps."""
    Vn, Hs, Ws = imgs.shape
    shape = x.shape
    x = torch.clamp(x, 0.0, Ws - 1.0).reshape(Vn, -1)
    y = torch.clamp(y, 0.0, Hs - 1.0).reshape(Vn, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i = torch.nan_to_num(x0, nan=0.0).to(torch.int64)
    y0i = torch.nan_to_num(y0, nan=0.0).to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=Ws - 1)
    y1i = torch.clamp(y0i + 1, max=Hs - 1)
    flat = imgs.reshape(Vn, -1)
    g = lambda yi, xi: torch.gather(flat, 1, yi * Ws + xi)
    i00, i01, i10, i11 = g(y0i, x0i), g(y0i, x1i), g(y1i, x0i), g(y1i, x1i)
    top = fma(fx, i01 - i00, i00)
    bot = fma(fx, i11 - i10, i10)
    return fma(fy, bot - top, top).reshape(shape)


def moments(vals, w_taps, wref_taps, fast):
    """The tap moments of vals [V, T, ...] in tap order."""
    s1 = s2 = s3 = torch.zeros_like(vals[:, 0])
    for t in range(vals.shape[1]):
        v = vals[:, t]
        wv = w_taps[t] * v
        s1 = s1 + wv
        if fast:
            s2 = fma(wv, v, s2)
            s3 = fma(wref_taps[t], v, s3)
        else:
            s2 = s2 + wv * v
            s3 = s3 + wref_taps[t] * v
    return s1, s2, s3


def capped_bilinear(imgs, x, y):
    """The kernels' border-clamped bilinear sample: the floor taken by
    adding 2^23 rounding down, capped at (W - 2, H - 2), so the four pixels
    are always (x0, y0) .. (x0 + 1, y0 + 1); blended as the plain version
    blends.  imgs [V, H, W], x, y [V, ...] -> [V, ...]."""
    Vn, Hs, Ws = imgs.shape
    shape = x.shape
    x = torch.clamp(x, 0.0, Ws - 1.0).reshape(Vn, -1)
    y = torch.clamp(y, 0.0, Hs - 1.0).reshape(Vn, -1)

    def floor_capped(v, hi):
        # x + 2^23 rounded down is 2^23 + floor(x) for 0 <= x < 2^23
        f = torch.floor(v.double() + 2.0 ** 23).float() - 2.0 ** 23
        f = torch.where(torch.isnan(f), torch.full_like(f, hi), f)
        return torch.clamp(f, max=hi)
    x0, y0 = floor_capped(x, Ws - 2.0), floor_capped(y, Hs - 2.0)
    fx, fy = x - x0, y - y0
    o = y0.to(torch.int64) * Ws + x0.to(torch.int64)
    flat = imgs.reshape(Vn, -1)
    g = lambda d: torch.gather(flat, 1, o + d)
    top = g(0) * (1 - fx) + g(1) * fx
    bot = g(Ws) * (1 - fx) + g(Ws + 1) * fx
    return (top * (1 - fy) + bot * fy).reshape(shape)


def sample(imgs, hx, hy, hz, fast):
    """The bilinear sample at (hx / hz, hy / hz), hz guarded."""
    hz = _guard(hz)
    if fast:
        rz = rcp(hz)
        return lerp_bilinear(imgs, hx * rz, hy * rz)
    return capped_bilinear(imgs, hx / hz, hy / hz)


def k1_model(planes, w_taps, wref_taps, wsums, src, M, b, cam, src_wh,
             radius=5.0, radius_map=None, parity=None, fast=False):
    """csrc/ncc_fused.cu's arithmetic (``fast``: the rejected one):
    [B, H', W', V]."""
    Bn, Hp, Wp, _ = planes.shape
    xs, ys = ncc_fused.eval_coords(Hp, Wp, parity, planes.device)
    rx = (xs - cam[0]) / cam[2]
    ry = (ys - cam[1]) / cam[3]
    inv_fx, inv_fy = 1.0 / cam[2], 1.0 / cam[3]
    rad = radius_map if radius_map is not None else float(radius)
    inv = 1.0 / torch.clamp(wsums[0], min=1e-30)
    axis = torch.as_tensor(_TAP_AXIS)
    out = []
    for plane in planes:
        base, colx, coly = plane_warp_fields(M, b, plane, rx, ry, inv_fx,
                                             inv_fy)
        in_view = _center_inview(base, src_wh)
        pcx = [[axis[i] * rad * colx[c] for c in range(3)] for i in range(6)]
        vals = []
        for j in range(6):
            dj = axis[j] * rad
            pcy = [dj * coly[c] for c in range(3)]
            row = [fma(dj, coly[c], base[c]) for c in range(3)] if fast \
                else None
            for i in range(6):
                if fast:
                    h = [fma(axis[i] * rad, colx[c], row[c])
                         for c in range(3)]
                else:
                    h = [(base[c] + pcx[i][c]) + pcy[c] for c in range(3)]
                vals.append(sample(src, *h, fast))
        s1, s2, s3 = moments(torch.stack(vals, 1), w_taps, wref_taps, fast)
        out.append(_ncc_from_moments(inv, wsums[1], wsums[2], s1, s2, s3,
                                     in_view))
    return torch.stack(out)


def k2_model(invd0, invbl, vweights, w_taps, wref_taps, wsums, src, M, b,
             cam, src_wh, K, k0, radius=5, fast=False):
    """csrc/sweep.cu's arithmetic (``fast``: the rejected one): [K, H, W]."""
    Hn, Wn = invd0.shape
    xs, ys = _grid(Hn, Wn, invd0.device)
    rx = (xs - cam[0]) / cam[2]
    ry = (ys - cam[1]) / cam[3]
    e = lambda a: a[:, None, None]
    mr_exact = [e(M[:, i, 0]) * rx + e(M[:, i, 1]) * ry + e(M[:, i, 2])
                for i in range(3)]
    mr_fma = [fma(e(M[:, i, 1]), ry, e(M[:, i, 0]) * rx) + e(M[:, i, 2])
              for i in range(3)]
    inv = 1.0 / torch.clamp(wsums[0], min=1e-30)
    m_ref = wsums[1] * inv
    var_ref = wsums[2] * inv - m_ref * m_ref
    ref_bad = var_ref < _K_MIN_VAR
    offs = torch.as_tensor(sweep_fused.tap_offsets(radius), dtype=torch.long)
    iy = torch.clamp(torch.arange(Hn)[None, :, None] + offs[0][:, None, None],
                     0, Hn - 1)
    ix = torch.clamp(torch.arange(Wn)[None, None, :] + offs[1][:, None, None],
                     0, Wn - 1)
    out = []
    for k in range(K):
        invd_e = invd0 + float(k - k0) * invbl
        if fast:
            invd = fma(torch.tensor(float(k - k0)), invbl, invd0)
            h = [fma(e(b[:, c]), invd, mr_fma[c]) for c in range(3)]
        else:
            h = [mr_exact[c] + e(b[:, c]) * invd_e for c in range(3)]
        field = sample(src, *h, fast)                              # [V, H, W]
        s1, s2, s3 = moments(field[:, iy, ix], w_taps, wref_taps, fast)
        hxe, hye, hze = (mr_exact[c] + e(b[:, c]) * invd_e for c in range(3))
        pxu, pyu = hxe / _guard(hze), hye / _guard(hze)
        in_view = ((pxu >= 0) & (pxu < e(src_wh[:, 0])) & (pyu >= 0)
                   & (pyu < e(src_wh[:, 1])) & (hze > 0))
        m_src = s1 * inv
        var_src = s2 * inv - m_src * m_src
        covar = s3 * inv - m_ref * m_src
        vp = fmath.sqrt(torch.clamp(var_ref * var_src, min=0.0))
        cost = torch.clamp(1.0 - covar / torch.clamp(vp, min=1e-30), 0.0,
                           COST_MAX)
        bad = ref_bad | (var_src < _K_MIN_VAR) | ~in_view
        cost = torch.where(bad, torch.full_like(cost, COST_MAX), cost)
        acc = torch.zeros_like(invd0)
        for v in range(cost.shape[0]):
            acc = fma(vweights[v], cost[v], acc) if fast else \
                acc + vweights[v] * cost[v]
        out.append(acc)
    return torch.stack(out)


def spread(got, want, bound):
    """chip_smoke.compare's measure: (median |d|, share of |d| > bound);
    NaN in both agrees, NaN in one does not."""
    d = torch.abs(got - want)
    d = torch.where(torch.isnan(got) & torch.isnan(want),
                    torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    d = d.flatten().double()
    return float(d.median()), float((d > bound).double().mean())


def scene_inputs(height, width, views, seed, rows=None):
    """Reference and source views of make_scene, the ground-truth plane
    field, B planes with w scaled by 1 +- 5 %, a radius map, view weights,
    and a full-grid cost context; ``rows`` keeps the first rows of the
    per-pixel fields (the sources stay whole)."""
    sc = make_scene(num_views=5, height=height, width=width, seed=seed)
    reps = [[1, 2, 3, 4][j % 4] for j in range(views)]
    ref, src = sc.cameras[0], stack_cameras([sc.cameras[i] for i in reps])
    img = torch.as_tensor(sc.images)
    xs, ys = _grid(height, width, "cpu")
    depth = torch.as_tensor(sc.gt_depth[0])
    plane = plane_from_normal_depth(torch.as_tensor(sc.gt_normal[0]), depth,
                                    xs, ys, ref)
    rng = np.random.default_rng(0)
    planes = plane[None].repeat(B, 1, 1, 1)
    planes[..., 3] *= torch.as_tensor(
        1.0 + 0.1 * (rng.uniform(size=(B, height, width)) - 0.5),
        dtype=torch.float32)
    rmap = torch.as_tensor(rng.uniform(3.0, 7.0, (height, width)).astype(
        np.float32))
    vw = torch.as_tensor(rng.uniform(size=(views, height, width)).astype(
        np.float32))
    ctx = build_cost_context(img[0], img[reps].contiguous(), ref, src, 5.0,
                             3.0, backend="fused")
    sel = torch.ones((height, width, views), dtype=torch.bool)
    baseline, _ = _mean_selected_baseline(sel, ref, src)
    fxbl = ref.fx * baseline
    invbl = torch.where(fxbl > 0, 1.0 / torch.clamp(fxbl, min=1e-12),
                        torch.zeros_like(fxbl))
    r = slice(None) if rows is None else slice(0, rows)
    cut = lambda t: t[..., r, :].contiguous()
    ctx = ctx.replace(**{f: cut(getattr(ctx, f)) for f in (
        "rx", "ry", "radius", "w_taps", "wref_taps", "sum_w", "sum_wref",
        "sum_wref2")})
    return dict(ref=ref, src=src, img=img, ctx=ctx,
                planes=planes[:, r].contiguous(), rmap=cut(rmap), vw=cut(vw),
                invd0=cut(1.0 / depth), invbl=cut(invbl), reps=reps)


@pytest.fixture(scope="module")
def scene():
    return scene_inputs(H, W, V, seed=2)


def k1_args(s, mode):
    ctx, planes, par = s["ctx"], s["planes"], None
    if mode == "radius_map":
        ctx = build_cost_context(s["img"][0], s["img"][s["reps"]], s["ref"],
                                 s["src"], 5.0, 3.0, backend="fused",
                                 radius_map=s["rmap"])
    if mode.startswith("parity"):
        par = int(mode[-1])
        ctx = pack_ctx(ctx, par)
        planes = pack_parity(planes, par, axis=1)
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    args = (planes.contiguous(), ctx.w_taps, ctx.wref_taps, wsums,
            ctx.src_imgs, ctx.M, ctx.b, ctx.cam, ctx.src_wh)
    return args, dict(radius=5.0, parity=par, radius_map=ctx.radius
                      if ctx.has_radius_map else None)


def k2_args(s):
    ctx = s["ctx"]
    invbl = s["invbl"].clone()
    invbl[:, : invbl.shape[1] // 3] = 0.0          # no motion on a part
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    return (s["invd0"], invbl, s["vw"], ctx.w_taps, ctx.wref_taps, wsums,
            ctx.src_imgs, ctx.M, ctx.b, ctx.cam, ctx.src_wh)


@pytest.mark.parametrize("mode", ["dense", "radius_map", "parity0",
                                  "parity1"])
def test_k1_arithmetic_equals_the_plain_version(scene, mode):
    args, kw = k1_args(scene, mode)
    want = ncc_fused.fused_ncc_costs_plain(*args, **kw)
    got = k1_model(*args, **kw)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    # the rejected arithmetic fits the tolerance at this small width
    med, share = spread(k1_model(*args, **kw, fast=True), want, 1e-3)
    assert med <= 1e-3 and share <= 1e-3


@pytest.mark.parametrize("K,k0", [(61, 30), (11, 5)])
def test_k2_arithmetic_equals_the_plain_version(scene, K, k0):
    args = k2_args(scene)
    want = sweep_fused.sweep_weighted_ncc_plain(*args, K=K, k0=k0)
    got = k2_model(*args, K=K, k0=k0)
    assert got.shape == (K, H, W) and torch.equal(got, want)
    med, share = spread(k2_model(*args, K=K, k0=k0, fast=True), want, 5e-3)
    assert med <= 5e-3 and share <= 1e-3


@pytest.fixture(scope="module")
def wide():
    """The first 24 rows of the 608x800 bench scene, V=10: the main path's
    width and view count."""
    return scene_inputs(608, 800, 10, seed=2, rows=24)


def test_fast_k1_arithmetic_breaks_the_tolerance_at_full_width(wide):
    args, kw = k1_args(wide, "parity0")
    want = ncc_fused.fused_ncc_costs_plain(*args, **kw)
    assert torch.equal(k1_model(*args, **kw), want)
    med, share = spread(k1_model(*args, **kw, fast=True), want, 1e-3)
    assert share > 1e-3, share


def test_fast_k2_arithmetic_breaks_the_tolerance_at_full_width(wide):
    args = k2_args(wide)
    want = sweep_fused.sweep_weighted_ncc_plain(*args, K=3, k0=1)
    assert torch.equal(k2_model(*args, K=3, k0=1), want)
    med, share = spread(k2_model(*args, K=3, k0=1, fast=True), want, 5e-3)
    assert share > 1e-3, share


def test_capped_corner_sampler_equals_the_plain_sampler():
    """At x = W - 1 (or y = H - 1) exactly the plain sampler blends the last
    pixel with itself at weight 0, the kernels' the last two at weights 0
    and 1: the same value, bitwise; NaN stays NaN."""
    rng = np.random.default_rng(3)
    imgs = torch.as_tensor(rng.uniform(0, 255, (2, 7, 9)).astype(np.float32))
    edge = np.array([0.0, 8.0, 7.999999, 3.5, 8.0, np.nan, 0.0, 6.0],
                    np.float32)
    x = np.concatenate([edge, rng.uniform(-2, 11, 500)]).astype(np.float32)
    y = np.concatenate([edge[::-1] * 0.75, rng.uniform(-2, 9, 500)]).astype(
        np.float32)
    x, y = (torch.as_tensor(np.stack([a, a[::-1].copy()])) for a in (x, y))
    got = capped_bilinear(imgs, x, y)
    want = _bilinear_sample_batch(imgs, x, y)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(want).any())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def _round_f32(x: Fraction) -> float:
    """x rounded to the nearest float32, ties to even (normal range)."""
    if x == 0:
        return 0.0
    sign, x = (-1.0 if x < 0 else 1.0), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    m = x / Fraction(2) ** (e - 23)                 # in [2^23, 2^24)
    q, r = divmod(m.numerator, m.denominator)
    if 2 * r > m.denominator or (2 * r == m.denominator and q % 2):
        q += 1
    return sign * float(np.float32(q * 2.0 ** (e - 23)))


def _fma32(a, b, c) -> float:
    """fmaf: a * b + c, exact, rounded once to float32."""
    return _round_f32(Fraction(float(a)) * Fraction(float(b))
                      + Fraction(float(c)))


def _shared_quotients(a, b, r0):
    """The kernels' quotients a / b from an approximate reciprocal r0 of b:
    one Newton step, then per quotient q = a r and one correction by the
    exact remainder a - b q (csrc/ncc_fused.cu::rcp_refined, quotient)."""
    r = _fma32(r0, _fma32(-b, r0, 1.0), r0)
    out = []
    for x in a:
        q = _fma32(x, r, 0.0)
        out.append(_fma32(r, _fma32(-b, q, x), q))
    return out


def test_shared_reciprocal_quotients_are_the_divides():
    """K1 and K2 divide a tap's (or sample's) hx and hy by hz with one
    refined reciprocal of hz, where taps with |hx|, |hy|, |hz| <= 2^60 and
    |hz| >= 1e-12 (the guard) take that path.  From any reciprocal within
    2 ulp of 1/hz (the hardware's approximate one is within 1), both
    quotients are the correctly rounded hx / hz: what __fdiv_rn gives and
    what the plain versions' divides give.  Operands: the main path's
    (hx ~ 1e2-1e4, hz ~ 1-10) and log-uniform over the whole range."""
    rng = np.random.default_rng(7)
    n = 400
    mag = lambda lo, hi: np.exp2(rng.uniform(lo, hi, n))
    sgn = lambda: rng.choice([-1.0, 1.0], n)
    hz = np.concatenate([rng.uniform(0.3, 12.0, n), sgn() * mag(-39.8, 60)])
    hx = np.concatenate([rng.uniform(-50.0, 900.0, n) * hz[:n],
                         sgn() * mag(-60, 60)])
    hy = np.concatenate([rng.uniform(-50.0, 700.0, n) * hz[:n],
                         sgn() * mag(-60, 60)])
    hx, hy, hz = (v.astype(np.float32) for v in (hx, hy, hz))
    checked = 0
    for a, c, b in zip(hx, hy, hz):
        exact = [_round_f32(Fraction(float(x)) / Fraction(float(b)))
                 for x in (a, c)]
        assert exact == [float(np.float32(x) / b) for x in (a, c)]
        r1 = np.float32(1.0) / b
        for ulps in (-2, -1, 0, 1, 2):
            r0 = np.float32(r1).view(np.int32) + ulps
            got = _shared_quotients((a, c), b,
                                    np.int32(r0).view(np.float32))
            assert got == exact, (a, c, b, ulps)
            checked += 1
    assert checked == 2 * n * 5


@pytest.mark.parametrize("radius", range(sweep_fused.MAX_HALO + 1))
def test_k2_compile_time_tap_offsets_match_the_wrapper(radius):
    """csrc/sweep.cu's constexpr tap_off (round(a * R) as (R + 2) / 5,
    (3 R + 2) / 5 and R, mirrored) equals tap_offsets, which the plain
    version reads."""
    axis = [-radius, -((3 * radius + 2) // 5), -((radius + 2) // 5),
            (radius + 2) // 5, (3 * radius + 2) // 5, radius]
    offs = sweep_fused.tap_offsets(radius)
    assert offs[0].tolist() == [a for a in axis for _ in axis]
    assert offs[1].tolist() == [a for _ in axis for a in axis]


def test_build_flags_per_source():
    """Only K1 and K2 are built with multiply-add contraction; the flags
    are part of each library's hash."""
    for name in _build.SOURCES:
        f = _build.flags(name)
        fmad = "-fmad=true" if name in ("ncc_fused", "sweep") else \
            "-fmad=false"
        assert fmad in f and sum(x.startswith("-fmad") for x in f) == 1
        assert "arch=compute_90a,code=sm_90a" in f
    saved = _build.CONTRACTED
    try:
        before = _build._target("geom")
        _build.CONTRACTED = saved + ("geom",)
        assert _build._target("geom") != before
    finally:
        _build.CONTRACTED = saved
    assert _build._target("geom") == before


def test_included_header_is_part_of_the_library_hash(tmp_path, monkeypatch):
    """A change to csrc/rcp.cuh rebuilds the four kernels that include it
    (K1-K4) and no other."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._target(n) for n in _build.SOURCES}
    with open(csrc / "rcp.cuh", "a") as f:
        f.write("// edited\n")
    changed = {n for n in _build.SOURCES if _build._target(n) != before[n]}
    assert changed == {"ncc_fused", "sweep", "geom", "anchor"}


# --- K4 (csrc/anchor.cu) and K3 (csrc/geom.cu) -----------------------------
#
# Both keep their plain versions' rounding: every product and sum in the
# plain order, the quotients of a shared refined reciprocal (the divides'
# bits, test_shared_reciprocal_quotients_are_the_divides).  K4's sampler
# departs from the plain version's steps (NaN-propagating clamps that may
# turn -0 into +0, a floor without the conversion unit, the corner capped at
# (W - 2, H - 2)); the test below holds those steps to the plain sampler
# bitwise.  The TPU kernel's composed form of K3 (two affine maps in inverse
# depth, contracted; geom_pallas.py:78-113) does not keep the rounding: its
# nearest-pixel lookups move, and the replay counts how far that is from the
# tolerance.

def _fadd_rd(a, b):
    """__fadd_rd: a + b rounded toward -inf to float32."""
    d = a.double() + b
    f = d.float()
    return torch.where(f.double() > d, torch.nextafter(
        f, torch.full_like(f, -float("inf"))), f)


def k4_sample(imgs, x, y, zero_to_pos):
    """csrc/anchor.cu's sample(): imgs [V, H, W], x, y [V, N].  clamp_nan
    (max.NaN then min.NaN; ``zero_to_pos``: the max turns -0 into +0),
    floor_capped (x + 2^23 rounded down, fminf with W - 2 + 2^23: a NaN
    coordinate caps to the corner), the four pixels (x0, y0) .. (x0 + 1,
    y0 + 1) blended as the plain version blends."""
    Vn, Hs, Ws = imgs.shape

    def clamp_nan(v, hi):
        r = torch.where(v < 0.0, torch.zeros_like(v), v)
        if zero_to_pos:
            r = torch.where(r == 0.0, torch.zeros_like(r), r)
        return torch.where(r > hi, torch.full_like(r, hi), r)

    def floor_capped(v, hi):
        t = _fadd_rd(v, 2.0 ** 23)
        hb = torch.full_like(t, hi + 2.0 ** 23)
        t = torch.where(torch.isnan(t), hb, torch.minimum(t, hb))
        return t - 2.0 ** 23
    x = clamp_nan(x, Ws - 1.0)
    y = clamp_nan(y, Hs - 1.0)
    x0, y0 = floor_capped(x, Ws - 2.0), floor_capped(y, Hs - 2.0)
    o = y0.to(torch.int64) * Ws + x0.to(torch.int64)
    flat = imgs.reshape(Vn, -1)
    g = lambda d: torch.gather(flat, 1, o + d)
    fx, fy = x - x0, y - y0
    top = g(0) * (1.0 - fx) + g(1) * fx
    bot = g(Ws) * (1.0 - fx) + g(Ws + 1) * fx
    return top * (1.0 - fy) + bot * fy


_K4_SAMPLE_CASES = {
    # (x, y) as fractions of (W - 1, H - 1), or the values themselves
    "corner": [(1.0, 1.0)],
    "edges": [(1.0, 0.3), (0.6, 1.0), (0.0, 1.0), (1.0, 0.0), (0.0, 0.0)],
    "outside": [(1.7, 1.2), (-0.5, 1.5), (1.5, -3.0), (-1e9, 1e9)],
    "nan": [(np.nan, 0.4), (0.4, np.nan), (np.nan, np.nan), (np.nan, 1.0),
            (1.0, np.nan)],
    "negative zero": [(-0.0, -0.0), (-0.0, 1.0), (1.0, -0.0), (-0.0, 0.5)],
    "interior": [],
}


@pytest.mark.parametrize("case", list(_K4_SAMPLE_CASES))
def test_k4_sampler_equals_the_plain_sampler(case):
    """csrc/anchor.cu's sampler gives the plain bilinear_sample's bits: at
    x = W - 1 and y = H - 1 (alone and both at once) its capped corner
    blends pixels W - 2, W - 1 at weights 0, 1 where the plain version
    blends W - 1 with itself; a NaN coordinate gives NaN; a -0 coordinate,
    kept or turned into +0 by the clamp, gives the same value."""
    rng = np.random.default_rng(11)
    imgs = torch.as_tensor(rng.uniform(0, 255, (2, 7, 9)).astype(np.float32))
    imgs[0, :, -1] = 0.0                     # zero pixels on the far edge
    imgs[1, -1, :] = 0.0
    pts = np.array(_K4_SAMPLE_CASES[case] or [(0.5, 0.5)], np.float64)
    if case != "negative zero":
        pts = pts * np.array([8.0, 6.0])
    if case == "interior":
        pts = rng.uniform(0, 1, (400, 2)) * np.array([8.0, 6.0])
    x = torch.as_tensor(pts[:, 0].astype(np.float32))[None].repeat(2, 1)
    y = torch.as_tensor(pts[:, 1].astype(np.float32))[None].repeat(2, 1)
    want = _bilinear_sample_batch(imgs, x, y)
    assert bool(torch.isnan(want).any()) == (case == "nan")
    for zero_to_pos in (False, True):
        got = k4_sample(imgs, x, y, zero_to_pos)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        keep = ~torch.isnan(want)
        assert torch.equal(got[keep].view(torch.int32),
                           want[keep].view(torch.int32))


def _geom_strip(rows=24):
    """The first ``rows`` rows of the 608x800 bench scene, V=10: a geom
    context on the other views' ground-truth depths (full maps), the depth
    stacks of chip_smoke.py's K3 rows by mode (K=61 and K=8 disparity steps
    around the ground truth, the parity stacks of K=10 depths scaled by
    1 +- 10 %), and view weights."""
    from dvpmvs_torch.kernels.geom import build_geom_context
    s = scene_inputs(608, 800, 10, seed=2, rows=rows)
    sc = make_scene(num_views=5, height=608, width=800, seed=2)
    ref = s["ref"]
    gctx = build_geom_context(torch.as_tensor(sc.gt_depth[s["reps"]]), ref,
                              s["src"])
    cut = lambda t: t[:rows].contiguous()
    gctx = dataclasses.replace(gctx, **{f: cut(getattr(gctx, f))
                                        for f in ("xs", "ys", "rx", "ry")})
    gt = torch.as_tensor(sc.gt_depth[0][:rows])
    baseline, _ = _mean_selected_baseline(
        torch.ones((rows, 800, 10), dtype=torch.bool), ref, s["src"])
    fxbl = ref.fx * baseline
    sweep = lambda K: (fxbl / (fxbl / gt + (torch.arange(
        K, dtype=torch.float32) - K // 2)[:, None, None])).contiguous()
    ks10 = 1.0 + 0.02 * (torch.arange(10, dtype=torch.float32) - 5)
    stacks = {"fold": sweep(61), "per view": sweep(8)}
    stacks.update({f"parity{c}": (pack_parity(gt, c)[None]
                                  * ks10[:, None, None]).contiguous()
                   for c in (0, 1)})
    return gctx, stacks, torch.movedim(s["vw"], 0, -1)


def k3_composed(gctx, depths, vweights=None, fold=False, parity=None):
    """The TPU kernel's composed form (geom_pallas.py:78-113, _geom_consts
    at :123-145) with contraction: h = M r + b / d and h2 = N X_src + g as
    FMA chains, one reciprocal a quotient pair, inverse focal lengths."""
    from dvpmvs_torch.kernels.geom_fused import parity_context
    from dvpmvs_torch.kernels.geom import _nearest_index
    if parity is not None:
        gctx = parity_context(gctx, parity)
    V, H, W = gctx.src_depths.shape
    f32 = lambda x: x.to(torch.float32)
    Ms = f32(torch.einsum("vij,vjk,lk->vil", gctx.src_K, gctx.src_R,
                          gctx.ref_R))
    bs = f32(torch.einsum("vij,vj->vi", gctx.src_K, torch.einsum(
        "vij,j->vi", gctx.src_R, gctx.ref_c) + gctx.src_t))
    Ns = f32(torch.einsum("ij,jk,vlk->vil", gctx.ref_K, gctx.ref_R,
                          gctx.src_R))
    gs = f32(torch.einsum("ij,vj->vi", gctx.ref_K, torch.einsum(
        "ij,vj->vi", gctx.ref_R, gctx.src_c)) + (gctx.ref_K @ gctx.ref_t))
    rK = gctx.ref_K
    xf, yf = gctx.xs, gctx.ys
    rx = (xf - rK[0, 2]) * (1.0 / rK[0, 0])
    ry = (yf - rK[1, 2]) * (1.0 / rK[1, 1])
    g = lambda x: torch.where(torch.abs(x) < 1e-12,
                              torch.full_like(x, 1e-12), x)
    invd = torch.where(depths > 0, 1.0 / torch.clamp(depths, min=1e-12),
                       torch.zeros_like(depths))
    acc, per_view = torch.zeros_like(depths), []
    for v in range(V):
        M, bb, N, gg = Ms[v], bs[v], Ns[v], gs[v]
        mr = [fma(M[c, 0], rx, fma(M[c, 1], ry, M[c, 2])) for c in range(3)]
        h = [fma(bb[c], invd, mr[c]) for c in range(3)]
        rz = rcp(g(h[2]))
        sx, sy = h[0] * rz, h[1] * rz
        flat = (_nearest_index(sy, H).to(torch.int64) * W
                + _nearest_index(sx, W))
        sd = gctx.src_depths[v].reshape(-1)[flat]
        sK = gctx.src_K[v]
        bx = sd * (sx - sK[0, 2]) * (1.0 / sK[0, 0])
        by = sd * (sy - sK[1, 2]) * (1.0 / sK[1, 1])
        h2 = [fma(N[c, 0], bx, fma(N[c, 1], by, fma(N[c, 2], sd, gg[c])))
              for c in range(3)]
        rz2 = rcp(g(h2[2]))
        dx, dy = xf - h2[0] * rz2, yf - h2[1] * rz2
        dist = fmath.sqrt(fma(dx, dx, dy * dy))
        cost = torch.clamp(dist, max=3.0)
        cost = torch.where((sd <= 0) | ~torch.isfinite(dist),
                           torch.full_like(cost, 3.0), cost)
        if fold:
            acc = fma(vweights[..., v], cost, acc)
        else:
            per_view.append(cost)
    return acc if fold else torch.stack(per_view, -1)


@pytest.fixture(scope="module")
def geom_strip():
    return _geom_strip()


@pytest.mark.parametrize("mode", ["fold", "per view", "parity0",
                                  "parity1"])
def test_composed_k3_arithmetic_fits_the_tolerance_at_full_width(
        geom_strip, mode):
    """The composed form moves some nearest-pixel lookups (max |d| up to
    ~0.2 at 608x800), but on few entries: the share above 1e-3 stays an
    order of magnitude under chip_smoke.py's 1e-3."""
    from dvpmvs_torch.kernels.geom_fused import geom_cost_plain
    gctx, stacks, vw = geom_strip
    fold = mode == "fold"
    kw = dict(vweights=vw if fold else None, fold=fold,
              parity=int(mode[-1]) if mode.startswith("parity") else None)
    want = geom_cost_plain(gctx, stacks[mode], **kw)
    got = k3_composed(gctx, stacks[mode], **kw)
    assert not torch.equal(got, want)
    med, share = spread(got, want, 1e-3)
    assert med <= 1e-4 and share <= 1e-4, (med, share)
