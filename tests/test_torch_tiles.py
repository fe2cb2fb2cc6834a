"""The port's row-tiled pass (``dvpmvs_torch/dist/tiles.py``) on the CPU.

Port only, production draws (``TorchDraws``).  Each pass case of
tests/torch_dist_worker.py (``TILE_CASES``, 32x48 and one 30x48 case whose
second window starts on an odd row) runs through ``make_tiled_pass`` over
two and over four gloo ranks (one launch each, one torch thread a rank:
``dvpmvs_torch.dist.launch``, a rendezvous file in a temporary folder), and
every rank's whole ``PassOutput`` must equal the untiled ``run_pass`` on the
same inputs and draws bit for bit; the ranks also compute the untiled
references, split among them.  The row windows of K1, K2, K3 and K5's plain
versions, one of them from an odd row, equal the rows of the whole-image
call; ``mesh2_layout`` mirrors JAX's ``make_mesh2`` and ``make_tiled_pass``
refuses rows that do not divide, as JAX's tests/test_dist.py holds them.
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as worker

from dvpmvs_torch.dist import (ViewMesh, launch, make_tiled_pass,
                               mesh2_layout, row_bounds)
from dvpmvs_torch.engine.packing import pack_parity

NAMES4 = ("first/fused", "iter/fused", "iter/fused/radius", "iter/warp",
          "apd/fused/labels", "apd/warp")
NAMES2 = tuple(worker.TILE_CASES)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: the ranks' results} of one launch over n = 2 and n = 4 ranks."""
    out = {}
    for n, names in ((2, NAMES2), (4, NAMES4)):
        work = tmp_path_factory.mktemp(f"tiles{n}")
        out[n] = launch(worker.tiles_rank, n, (names,), workdir=work,
                        devices=["cpu"] * n, threads=1)
    return out


CASES = [(2, name) for name in NAMES2] + [(4, name) for name in NAMES4]


@pytest.mark.parametrize("n, name", CASES,
                         ids=[f"{n}-{name}" for n, name in CASES])
def test_tiled_pass_equals_untiled(ranks, n, name):
    """Every rank's whole PassOutput equals the untiled pass bit for bit
    (depth, normals, cost, weak classes, selected views, view weights,
    radius, the compaction overflow and the debug fields)."""
    results = ranks[n]
    want = next(r["ref"][name] for r in results if name in r["ref"])
    assert want["weak_overflow"] is None or name.startswith("apd") or \
        name.startswith("init")
    if name == "apd/overflow/debug":
        assert int(want["weak_overflow"]) > 0
        assert want["cost_line"] is not None
    for r, res in enumerate(results):
        got = res["tiled"][name]
        for f, w in want.items():
            g = got[f]
            assert (g is None) == (w is None), (r, f)
            if w is not None:
                assert g.dtype == w.dtype and g.shape == w.shape, (r, f)
                np.testing.assert_array_equal(g, w, err_msg=f"rank {r} {f}")
    assert (want["depth"] > 0).mean() > 0.5


def test_mesh2_layout_mirrors_jax():
    """JAX's test_mesh2_composition on its 8 devices: (2, 4) fits, (4, 4)
    is refused; rank v * n_tiles + t sits at (v, t)."""
    views, tiles = mesh2_layout(8, 2, 4)
    assert views == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert tiles == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        mesh2_layout(8, 4, 4)


def test_make_mesh2_over_four_ranks(tmp_path):
    """make_mesh2(2, 2) over four gloo ranks: each rank's subgroups hold
    the ranks of its layout row and column, in order."""
    outs = launch(worker.mesh2_rank, 4, (2, 2), workdir=tmp_path,
                  devices=["cpu"] * 4, threads=1)
    for r, o in enumerate(outs):
        v, t = divmod(r, 2)
        assert o["views"] == (v, 2) and o["tile"] == (t, 2)
        assert o["views_ranks"] == [t, 2 + t]
        assert o["tile_ranks"] == [2 * v, 2 * v + 1]


def test_tiled_pass_rejects_indivisible_rows():
    """H = 30 over four tile ranks raises ValueError before any work, as
    JAX's make_tiled_pass does (tests/test_dist.py:150)."""
    (img, srcs, rc, sc, st, dyn, draws), kw = worker.tile_case("first/fused")
    fn = make_tiled_pass(st, ViewMesh(object(), 1, 4, torch.device("cpu")))
    with pytest.raises(ValueError, match="not divisible by tile axis 4"):
        fn(img[:30], srcs[:, :30], rc, sc, dyn, draws)
    assert row_bounds(32, 3, 4) == (24, 32)


# ------------------------------------------- the kernels over a row window --

H, W, V = 30, 40, 3
Y0, Y1 = 11, 23          # an odd first row


@pytest.fixture(scope="module")
def inputs():
    from dvpmvs_torch.config import PMDynamic
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.kernels.geom import build_geom_context
    from dvpmvs_torch.kernels.ncc import build_cost_context
    from dvpmvs_torch.utils.synthetic import make_scene

    scene = make_scene(num_views=V + 1, height=H, width=W, seed=2)
    ref = scene.cameras[0]
    src_cams = stack_cameras(scene.cameras[1:])
    dyn = PMDynamic.create(depth_min=float(ref.depth_min),
                           depth_max=float(ref.depth_max))
    rng = np.random.default_rng(1)
    img = torch.as_tensor(scene.images[0])
    srcs = torch.as_tensor(np.asarray(scene.images[1:]))
    radius = torch.as_tensor(np.where(rng.uniform(size=(H, W)) < 0.5, 5.0,
                                      7.5).astype(np.float32))
    ctx = build_cost_context(img, srcs, ref, src_cams, dyn.sigma_spatial,
                             dyn.sigma_color, radius_map=radius,
                             backend="fused")
    ctx_s = build_cost_context(img, srcs, ref, src_cams, dyn.sigma_spatial,
                               dyn.sigma_color, backend="fused")
    depth = torch.as_tensor(scene.gt_depth[0] * (1 + 0.03 * rng.standard_normal(
        (H, W)))).to(torch.float32)
    normal = torch.as_tensor(scene.gt_normal[0] @ np.asarray(ref.R)
                             ).to(torch.float32)
    planes = torch.stack([torch.cat([normal, (depth * (1 + 0.01 * k))[
        ..., None]], -1) for k in range(3)])
    from dvpmvs_torch.kernels.sampling import plane_from_normal_depth
    from dvpmvs_torch.kernels.ncc import _grid
    xs, ys = _grid(H, W, "cpu")
    planes = torch.stack([plane_from_normal_depth(p[..., :3], p[..., 3], xs,
                                                  ys, ref) for p in planes])
    gctx = build_geom_context(torch.as_tensor(np.stack(scene.gt_depth[1:])
                                              ).to(torch.float32),
                              ref, src_cams)
    vw = torch.as_tensor(rng.uniform(size=(H, W, V)).astype(np.float32))
    return dict(ctx=ctx, ctx_s=ctx_s, planes=planes, depth=depth, gctx=gctx,
                vw=vw, radius=radius)


def _k1(ctx, planes, parity, y0, y1, pk):
    from dvpmvs_torch.kernels.ncc_fused import fused_ncc_costs
    f = lambda a, axis=0: pk(a.narrow(axis, y0, y1 - y0), axis)
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    return fused_ncc_costs(
        f(planes, 1).contiguous(), f(ctx.w_taps, 1).contiguous(),
        f(ctx.wref_taps, 1).contiguous(), f(wsums, 1).contiguous(),
        ctx.src_imgs, ctx.M, ctx.b, ctx.cam, ctx.src_wh,
        radius=5.0, radius_map=f(ctx.radius).contiguous(), parity=parity,
        y0=y0)


@pytest.mark.parametrize("parity", [None, 0, 1])
def test_k1_plain_row_window_equals_whole_rows(inputs, parity):
    """K1's plain version, dense and on both checkerboard colors, per-pixel
    radius: rows [11, 23) alone equal those rows of the whole image."""
    ctx, planes = inputs["ctx"], inputs["planes"]
    pk = ((lambda a, axis=0: a) if parity is None
          else (lambda a, axis=0, y0=0: pack_parity(a, parity, axis, y0)))
    whole = _k1(ctx, planes, parity, 0, H, pk)
    pkw = ((lambda a, axis=0: a) if parity is None
           else (lambda a, axis=0: pack_parity(a, parity, axis, Y0)))
    win = _k1(ctx, planes, parity, Y0, Y1, pkw)
    torch.testing.assert_close(win, whole[:, Y0:Y1], rtol=0, atol=0)


def test_k2_plain_row_window_equals_whole_rows(inputs):
    """K2's plain version (K = 11): rows [11, 23) with invd0 and invbl
    whole (the halo reads the real rows) equal the whole image's rows."""
    from dvpmvs_torch.kernels.sweep_fused import sweep_weighted_ncc
    ctx, depth, vw = inputs["ctx_s"], inputs["depth"], inputs["vw"]
    invd0 = 1.0 / depth
    invbl = torch.full_like(depth, 0.01)
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])

    def run(y0, y1):
        r = lambda a, axis=0: a.narrow(axis, y0, y1 - y0).contiguous()
        return sweep_weighted_ncc(
            invd0, invbl, r(torch.movedim(vw, -1, 0), 1), r(ctx.w_taps, 1),
            r(ctx.wref_taps, 1), r(wsums, 1), ctx.src_imgs, ctx.M, ctx.b,
            ctx.cam, ctx.src_wh, K=11, k0=5, radius=5, y0=y0)
    torch.testing.assert_close(run(Y0, Y1), run(0, H)[:, Y0:Y1], rtol=0,
                               atol=0)


@pytest.mark.parametrize("mode", ["per view", "fold", "parity 0",
                                  "parity 1", "cyclic"])
def test_k3_plain_row_window_equals_whole_rows(inputs, mode):
    """K3's plain version per view, folded and on both colors: rows
    [11, 23) equal the whole image's rows; a cyclic window (rows -3 .. 8,
    the warp backend's halo over the first row) equals those rows."""
    from dvpmvs_torch.kernels.geom_fused import geom_cost
    gctx, depth, vw = inputs["gctx"], inputs["depth"], inputs["vw"]
    stack = torch.stack([depth * (1 + 0.02 * k) for k in range(3)])
    if mode.startswith("parity"):
        c = int(mode[-1])
        whole = geom_cost(gctx, pack_parity(stack, c, 1), parity=c)
        win = geom_cost(gctx, pack_parity(stack[:, Y0:Y1], c, 1, Y0),
                        parity=c, y0=Y0)
        torch.testing.assert_close(win, whole[:, Y0:Y1], rtol=0, atol=0)
        return
    kw = dict(fold=True) if mode == "fold" else {}
    whole = geom_cost(gctx, stack, vweights=vw if kw else None, **kw)
    if mode == "cyclic":
        rows = torch.remainder(torch.arange(-3, 9), H)
        win = geom_cost(gctx, stack[:, rows], y0=-3)
        torch.testing.assert_close(win, whole[:, rows], rtol=0, atol=0)
        return
    win = geom_cost(gctx, stack[:, Y0:Y1].contiguous(),
                    vweights=vw[Y0:Y1] if kw else None, y0=Y0, **kw)
    torch.testing.assert_close(win, whole[:, Y0:Y1], rtol=0, atol=0)


@pytest.mark.parametrize("y0", [Y0, 0])
def test_k5_plain_row_window_equals_whole_rows(inputs, y0):
    """K5's warp NCC (radius 3) on the window's rows with 3 rows of halo on
    each side (cyclic for the first rows, as the image's taps wrap): its
    inner rows are the whole-image costs of those rows."""
    from dvpmvs_torch.kernels.warp_fused import warp_ncc
    ctx, planes = inputs["ctx_s"], inputs["planes"]
    R, h = 3, Y1 - Y0

    def run(rows, y0=0):
        r = lambda a, axis=0: a.index_select(axis, rows)
        return warp_ncc(r(planes, 1), ctx.src_imgs, ctx.M, ctx.b, ctx.cam,
                        ctx.src_wh, r(ctx.w_taps, 1), r(ctx.wref_taps, 1),
                        r(ctx.sum_w), r(ctx.sum_wref), r(ctx.sum_wref2), R,
                        y0=y0)
    whole = run(torch.arange(H))
    win = run(torch.remainder(torch.arange(y0 - R, y0 + h + R), H), y0 - R)
    torch.testing.assert_close(win[:, R:R + h], whole[:, y0:y0 + h], rtol=0,
                               atol=0)
