"""The port's kernels against their plain versions on the card.

Needs an NVIDIA GPU, nvcc and nothing of JAX; without a card each test
skips.  On a machine without JAX, run it without the repository's
conftest (which sets up JAX for the other tests):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

The kernels round every operation as their plain versions do (K3-K6 are
built without multiply-add contraction; K1 and K2 use explicit
round-to-nearest intrinsics) and accumulate in the same order, so they
agree bitwise at these shapes.  The measure is chip_smoke.py's: median
|d| <= 1e-3 (K2: 5e-3) and a share <= 1e-3 of the entries above it.
"""

import ctypes

import numpy as np
import pytest
import torch

from dvpmvs_torch.engine.packing import pack_ctx, pack_parity
from dvpmvs_torch.geometry import stack_cameras
from dvpmvs_torch.bench import gather_variants
from dvpmvs_torch.kernels import (_build, anchor_fused, geom_fused,
                                  ncc_fused, sweep_fused, warp_fused)
from dvpmvs_torch.kernels.geom import build_geom_context
from dvpmvs_torch.kernels.ncc import _grid, build_cost_context
from dvpmvs_torch.kernels.sampling import plane_from_normal_depth
from dvpmvs_torch.utils.synthetic import make_scene

H, W, V = 48, 160, 2
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=4)
    ref = scene.cameras[0].to(dev)
    src = stack_cameras(scene.cameras[1:]).to(dev)
    img = torch.as_tensor(scene.images, device=dev)
    rmap = torch.as_tensor(np.random.default_rng(0).uniform(
        3.0, 7.0, (H, W)).astype(np.float32), device=dev)
    xs, ys = _grid(H, W, dev)
    depth = torch.as_tensor(scene.gt_depth[0], device=dev)
    plane = plane_from_normal_depth(
        torch.as_tensor(scene.gt_normal[0], device=dev), depth, xs, ys, ref)
    planes = torch.stack([plane, plane * torch.tensor(
        [1.0, 1.0, 1.0, 1.1], device=dev)])
    return dict(dev=dev, scene=scene, ref=ref, src=src, img=img, rmap=rmap,
                depth=depth, planes=planes)


def _agree(got, want, bound=1e-3):
    """chip_smoke.compare's measure: NaN in both agrees, NaN in one does
    not; median |d| <= bound and a share <= 1e-3 above it."""
    assert got.shape == want.shape
    d = torch.abs(got - want)
    d = torch.where(torch.isnan(got) & torch.isnan(want),
                    torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    share = float((d > bound).double().mean())
    assert share <= 1e-3 and float(d.double().median()) <= bound, share


def _ncc_args(ctx, planes):
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    return (planes.contiguous(), ctx.w_taps.contiguous(),
            ctx.wref_taps.contiguous(), wsums, ctx.src_imgs, ctx.M, ctx.b,
            ctx.cam, ctx.src_wh)


@pytest.mark.parametrize("mode", ["dense", "radius_map", "parity0",
                                  "parity1"])
def test_ncc_kernel_matches_plain(card, mode):
    c = card
    ctx = build_cost_context(c["img"][0], c["img"][1:], c["ref"], c["src"],
                             5.0, 3.0, backend="fused",
                             radius_map=c["rmap"] if mode == "radius_map"
                             else None)
    planes, par = c["planes"], None
    if mode.startswith("parity"):
        par = int(mode[-1])
        ctx = pack_ctx(ctx, par)
        planes = pack_parity(planes, par, axis=1)
    args = _ncc_args(ctx, planes)
    kw = dict(radius_map=ctx.radius.contiguous() if ctx.has_radius_map
              else None, parity=par)
    before = _build.LAUNCHES["ncc_fused"]
    got = ncc_fused.fused_ncc_costs(*args, **kw)
    assert _build.LAUNCHES["ncc_fused"] == before + 1
    _agree(got, ncc_fused.fused_ncc_costs_plain(*args, **kw))


def test_sweep_kernel_matches_plain(card):
    c = card
    ctx = build_cost_context(c["img"][0], c["img"][1:], c["ref"], c["src"],
                             5.0, 3.0, backend="fused")
    invd0 = (1.0 / c["depth"]).contiguous()
    invbl = torch.full((H, W), 1.0 / (float(c["ref"].fx) * 0.3),
                       device=c["dev"])
    vw = torch.rand((V, H, W), generator=torch.Generator(
        device=c["dev"]).manual_seed(0), device=c["dev"])
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    args = (invd0, invbl, vw, ctx.w_taps, ctx.wref_taps, wsums,
            ctx.src_imgs, ctx.M, ctx.b, ctx.cam, ctx.src_wh)
    got = sweep_fused.sweep_weighted_ncc(*args, K=9, k0=4)
    _agree(got, sweep_fused.sweep_weighted_ncc_plain(*args, K=9, k0=4), 5e-3)


@pytest.fixture(scope="module")
def ragged():
    """A 37 x 101 scene: no tile of K1 (32 pixels) or K2 (16 x 32) fits
    it evenly, dense or packed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    Hr, Wr = 37, 101
    scene = make_scene(num_views=V + 1, height=Hr, width=Wr, seed=5)
    ref = scene.cameras[0].to(dev)
    src = stack_cameras(scene.cameras[1:]).to(dev)
    img = torch.as_tensor(scene.images, device=dev)
    xs, ys = _grid(Hr, Wr, dev)
    depth = torch.as_tensor(scene.gt_depth[0], device=dev)
    plane = plane_from_normal_depth(
        torch.as_tensor(scene.gt_normal[0], device=dev), depth, xs, ys, ref)
    ctx = build_cost_context(img[0], img[1:], ref, src, 5.0, 3.0,
                             backend="fused")
    src_depths = torch.as_tensor(scene.gt_depth[1:], device=dev)
    return dict(dev=dev, ref=ref, src=src, depth=depth, plane=plane, ctx=ctx,
                img=img, src_depths=src_depths)


def _k1(ctx, planes, par):
    """K1 and its plain version on ``planes`` (dense, or packed on color
    ``par``); the kernel's launch is counted."""
    if par is not None:
        ctx = pack_ctx(ctx, par)
        planes = pack_parity(planes, par, axis=1)
    args = _ncc_args(ctx, planes)
    kw = dict(radius_map=ctx.radius.contiguous() if ctx.has_radius_map
              else None, parity=par)
    before = _build.LAUNCHES["ncc_fused"]
    got = ncc_fused.fused_ncc_costs(*args, **kw)
    assert _build.LAUNCHES["ncc_fused"] == before + 1
    return got, ncc_fused.fused_ncc_costs_plain(*args, **kw)


@pytest.mark.parametrize("par", [None, 0, 1])
def test_ncc_kernel_ragged_shape(ragged, par):
    """K1 at 37 x 101 with 5 planes (the last of a block's pixels and of
    its staged planes are partial)."""
    r = ragged
    scale = torch.linspace(0.9, 1.1, 5, device=r["dev"])
    planes = r["plane"][None].repeat(5, 1, 1, 1)
    planes[..., 3] *= scale[:, None, None]
    got, want = _k1(r["ctx"], planes.contiguous(), par)
    assert tuple(got.shape) == (5, 37, 101 if par is None else 51, V)
    _agree(got, want)


def test_ncc_kernel_degenerate_planes(ragged):
    """w = 0 at some pixels (NaN coordinates: NaN where the plain version
    has NaN, 2 where it has 2) and a plane just behind the reference
    camera, which puts every window center behind a source camera
    (hz <= 0: cost 2)."""
    from dvpmvs_torch.kernels.ncc import plane_warp_fields
    r = ragged
    ctx = r["ctx"]
    zero_w = r["plane"].clone()
    zero_w[5:9, 20:60, 3] = 0.0
    behind = r["plane"] * torch.tensor([1.0, 1.0, 1.0, -1e-3],
                                       device=r["dev"])
    got, want = _k1(ctx, torch.stack([zero_w, behind]), None)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[0, 5:9, 20:60] == 2.0, want[0, 5:9, 20:60] == 2.0)
    _agree(got, want)
    base, _, _ = plane_warp_fields(ctx.M, ctx.b, behind, ctx.rx, ctx.ry,
                                   ctx.inv_fx, ctx.inv_fy)
    hz_neg = torch.movedim(base[2] <= 0, 0, -1)
    assert bool(hz_neg.any())
    assert bool((got[1][hz_neg] == 2.0).all())


def test_sweep_kernel_ragged_shape_no_motion(ragged):
    """K2 at 37 x 101 (partial tiles at the right and bottom borders) with
    invbl = 0 on the left third of the grid (no motion: every step reads
    the same field there)."""
    r = ragged
    ctx, dev = r["ctx"], r["dev"]
    Hr, Wr = r["depth"].shape
    invd0 = (1.0 / r["depth"]).contiguous()
    invbl = torch.full((Hr, Wr), 1.0 / (float(r["ref"].fx) * 0.3),
                       device=dev)
    invbl[:, : Wr // 3] = 0.0
    vw = torch.rand((V, Hr, Wr), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    args = (invd0, invbl.contiguous(), vw, ctx.w_taps, ctx.wref_taps, wsums,
            ctx.src_imgs, ctx.M, ctx.b, ctx.cam, ctx.src_wh)
    before = _build.LAUNCHES["sweep"]
    got = sweep_fused.sweep_weighted_ncc(*args, K=11, k0=5)
    assert _build.LAUNCHES["sweep"] == before + 1
    want = sweep_fused.sweep_weighted_ncc_plain(*args, K=11, k0=5)
    _agree(got, want, 5e-3)
    # no motion: every step is the same weighted sum where no tap reaches
    # past the left third
    still = got[:, :, : Wr // 3 - 5]
    assert torch.equal(still, still[:1].expand_as(still))
    with pytest.raises(ValueError):
        sweep_fused.sweep_weighted_ncc(*args, K=11, k0=5, radius=9)


@pytest.mark.parametrize("fold", [True, False])
def test_geom_kernel_matches_plain(card, fold):
    c = card
    src_depths = torch.as_tensor(c["scene"].gt_depth[1:], device=c["dev"])
    gctx = build_geom_context(src_depths, c["ref"], c["src"])
    ks = torch.linspace(0.9, 1.1, 5, device=c["dev"])
    dstack = (c["depth"][None] * ks[:, None, None]).contiguous()
    vw = torch.rand((H, W, V), generator=torch.Generator(
        device=c["dev"]).manual_seed(1), device=c["dev"])
    kw = dict(vweights=vw if fold else None, fold=fold)
    got = geom_fused.geom_cost(gctx, dstack, **kw)
    _agree(got, geom_fused.geom_cost_plain(gctx, dstack, **kw))


@pytest.mark.parametrize("color", [0, 1])
def test_geom_parity_kernel_matches_plain(card, color):
    c = card
    src_depths = torch.as_tensor(c["scene"].gt_depth[1:], device=c["dev"])
    gctx = build_geom_context(src_depths, c["ref"], c["src"])
    ks = torch.linspace(0.9, 1.1, 5, device=c["dev"])
    dstack = (pack_parity(c["depth"], color)[None]
              * ks[:, None, None]).contiguous()
    before = _build.MODE_LAUNCHES.get("geom/parity", 0)
    got = geom_fused.geom_cost(gctx, dstack, parity=color)
    assert _build.MODE_LAUNCHES["geom/parity"] == before + 1
    assert tuple(got.shape) == (5, H, (W + 1) // 2, V)
    _agree(got, geom_fused.geom_cost_plain(gctx, dstack, parity=color))


@pytest.mark.parametrize("K,taps", [(700, 0), (333, 0), (700, 2),
                                    (333, 1)])
def test_anchor_kernel_matches_plain(card, K, taps):
    """Random anchors over the image, 10 slot planes near the ground
    truth, views unselected at random and some anchors invalid; with
    ``taps`` > 0, random sample words (offsets in [-8, 7], u8 weights and
    refs) in the sparse-patch tap mode."""
    c = card
    A, S = 11, 10
    g = torch.Generator(device=c["dev"]).manual_seed(K)
    rand = lambda *shape: torch.rand(shape, generator=g, device=c["dev"])
    ax = (rand(A, K) * W).floor().to(torch.int32)
    ay = (rand(A, K) * H).floor().to(torch.int32)
    ref = c["ref"]
    rax = (ax.float() - ref.cx) / ref.fx
    ray = (ay.float() - ref.cy) / ref.fy
    ref_a = c["img"][0].reshape(-1)[(ay * W + ax).long()]
    w_col = torch.exp(-torch.abs(ref_a - 255.0 * rand(A, K)) / 18.0)
    vbits = (rand(A, K) < 0.85).to(torch.int32) * (
        (rand(A, K) < 0.9).to(torch.int32) | 2 * (rand(A, K) < 0.9).to(
            torch.int32))
    pix = (rand(S, K) * H * W).floor().long()
    planes = c["planes"][0].reshape(-1, 4)[pix]
    planes[..., 3] *= 1.0 + 0.1 * (rand(S, K) - 0.5)
    ctx = build_cost_context(c["img"][0], c["img"][1:], c["ref"], c["src"],
                             5.0, 3.0, backend="fused",
                             color_only_weights=True)
    words, inv_f = None, None
    if taps:
        words = torch.randint(0, 2 ** 24, (V, taps, A, K), generator=g,
                              device=c["dev"], dtype=torch.int32)
        inv_f = (ctx.inv_fx, ctx.inv_fy)
    args = (ctx.src_imgs, ctx.M, ctx.b, ctx.src_wh,
            anchor_fused.slot_q(planes), rax.contiguous(), ray.contiguous(),
            ref_a.contiguous(), w_col.contiguous(), vbits.contiguous(),
            words, inv_f)
    before = _build.LAUNCHES["anchor"]
    mode = "anchor/taps" if taps else "anchor/single tap"
    before_mode = _build.MODE_LAUNCHES.get(mode, 0)
    got = anchor_fused.anchor_slot_costs(*args)
    assert _build.LAUNCHES["anchor"] == before + 1
    assert _build.MODE_LAUNCHES[mode] == before_mode + 1
    want = anchor_fused.anchor_slot_costs_plain(*args)
    assert torch.equal(got.has_anchors, want.has_anchors)
    _agree(got.cost, want.cost)
    assert float((got.cost < 2.0).float().mean()) > 0.3


def test_warp_kernel_matches_plain(card):
    """K5 on the ground-truth plane field, a plane with w = 0 at some
    pixels (NaN coordinates) and a far plane (out of view): warped fields
    and in-view masks equal (NaN where the plain version has NaN)."""
    c = card
    ctx = build_cost_context(c["img"][0], c["img"][1:], c["ref"], c["src"],
                             5.0, 3.0, backend="warp")
    degenerate = c["planes"][0].clone()
    degenerate[5:9, 20:60, 3] = 0.0
    for plane in (c["planes"][0], degenerate, c["planes"][0] * torch.tensor(
            [1.0, 1.0, 1.0, 40.0], device=c["dev"])):
        args = (plane.contiguous(), ctx.src_imgs, ctx.M, ctx.b, ctx.cam,
                ctx.src_wh)
        before = _build.LAUNCHES["warp"]
        got_w, got_iv = warp_fused.warp_field(*args)
        assert _build.LAUNCHES["warp"] == before + 1
        want_w, want_iv = warp_fused.warp_field_plain(*args)
        assert torch.equal(got_iv, want_iv)
        _agree(got_w, want_w)


@pytest.fixture(scope="module")
def ragged7():
    """A 37 x 101 scene with 7 source views: no 16 x 32 tile of the warp
    backend's NCC fits it evenly, and its views take one whole and one
    partial chunk of 5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    Hr, Wr, V7 = 37, 101, 7
    scene = make_scene(num_views=V7 + 1, height=Hr, width=Wr, seed=5)
    ref = scene.cameras[0].to(dev)
    src = stack_cameras(scene.cameras[1:]).to(dev)
    img = torch.as_tensor(scene.images, device=dev)
    xs, ys = _grid(Hr, Wr, dev)
    plane = plane_from_normal_depth(
        torch.as_tensor(scene.gt_normal[0], device=dev),
        torch.as_tensor(scene.gt_depth[0], device=dev), xs, ys, ref)
    rmap = torch.as_tensor(np.random.default_rng(1).uniform(
        3.0, 7.0, (Hr, Wr)).astype(np.float32), device=dev)
    return dict(dev=dev, ref=ref, src=src, img=img, plane=plane, rmap=rmap)


@pytest.mark.parametrize("r", [1, 5, 9])
@pytest.mark.parametrize("B", [1, 8, 17])
def test_warp_ncc_kernel_matches_plain(ragged7, B, r):
    """The warp backend's NCC kernel at 37 x 101, V = 7, on B planes: the
    ground truth, then (B > 1) w = 0 at some pixels (NaN coordinates, whose
    NaN reaches every in-view window that reads them), a plane just behind
    the reference camera and a far plane (cost 2 wherever out of view) and
    perturbed copies; tap weights with a radius map at B = 8.  One launch
    for the batch, NaN where the plain version has NaN, and chip_smoke's
    measure (the two agree bitwise)."""
    c = ragged7
    dev = c["dev"]
    ctx = build_cost_context(c["img"][0], c["img"][1:], c["ref"], c["src"],
                             5.0, 3.0, strong_radius=r, backend="warp",
                             radius_map=c["rmap"] if B == 8 else None)
    gen = torch.Generator(device=dev).manual_seed(B + r)
    planes = c["plane"][None].repeat(B, 1, 1, 1)
    planes[..., 3] *= 1.0 + 0.1 * (torch.rand(
        planes.shape[:3], generator=gen, device=dev) - 0.5)
    if B > 1:
        planes[0] = c["plane"]
        planes[1, 5:9, 20:60, 3] = 0.0
        planes[2] = c["plane"] * torch.tensor([1.0, 1.0, 1.0, -1e-3],
                                              device=dev)
        planes[3] = c["plane"] * torch.tensor([1.0, 1.0, 1.0, 40.0],
                                              device=dev)
    args = (planes.contiguous(), ctx.src_imgs, ctx.M, ctx.b, ctx.cam,
            ctx.src_wh, ctx.w_taps, ctx.wref_taps, ctx.sum_w, ctx.sum_wref,
            ctx.sum_wref2, r)
    before = _build.MODE_LAUNCHES.get("warp/ncc", 0)
    planes_before = warp_fused.KERNEL_PLANES["ncc"]
    got = warp_fused.warp_ncc(*args)
    assert _build.MODE_LAUNCHES["warp/ncc"] == before + 1
    assert warp_fused.KERNEL_PLANES["ncc"] == planes_before + B
    want = warp_fused.warp_ncc_plain(*args)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (B, 37, 101, 7)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    _agree(got, want)
    assert float((want[0] < 2.0).float().mean()) > 0.3
    if B > 1:
        assert bool(torch.isnan(want[1]).any())
        for k in (2, 3):
            _, _, iv = warp_fused.warp_coords(planes[k], ctx.M, ctx.b,
                                              ctx.cam, ctx.src_wh)
            out = torch.movedim(~iv, 0, -1)
            assert bool(out.any()) and bool((got[k][out] == 2.0).all())


def test_warp_ncc_refuses_a_halo_beyond_shared_memory(ragged7):
    """At V = 7 a radius of 60 needs a halo whose block would exceed 227 KB
    of shared memory: the wrapper raises before launching, and never falls
    back to the plain version; radius 9 fits."""
    c = ragged7
    ctx = build_cost_context(c["img"][0], c["img"][1:], c["ref"], c["src"],
                             5.0, 3.0, strong_radius=60, backend="warp")
    args = (c["plane"][None].contiguous(), ctx.src_imgs, ctx.M, ctx.b,
            ctx.cam, ctx.src_wh, ctx.w_taps, ctx.wref_taps, ctx.sum_w,
            ctx.sum_wref, ctx.sum_wref2)
    lib = _build.library("warp")
    lib.warp_ncc_smem_bytes.restype = ctypes.c_int
    assert lib.warp_ncc_smem_bytes(7, 60) < 0
    assert 0 < lib.warp_ncc_smem_bytes(7, 9) <= 232448
    before = _build.MODE_LAUNCHES.get("warp/ncc", 0)
    planes_before = warp_fused.KERNEL_PLANES["ncc"]
    with pytest.raises(ValueError, match="shared memory"):
        warp_fused.warp_ncc(*args, 60)
    assert _build.MODE_LAUNCHES.get("warp/ncc", 0) == before
    assert warp_fused.KERNEL_PLANES["ncc"] == planes_before
    warp_fused.warp_ncc(*args, 9)
    assert _build.MODE_LAUNCHES["warp/ncc"] == before + 1


@pytest.mark.parametrize("grid", [(2, 2), (3, 5), (38, 4)])
@pytest.mark.parametrize("variant", gather_variants.VARIANTS)
def test_gather_bench_kernel_matches_plain(card, variant, grid):
    """K6 on grids of 8 x 128 tiles, bit for bit its plain version, one
    launch counted a call.  (3, 5) leaves the persistent grid's deal of
    warp units a remainder; (38, 4) is the benchmark's 304 x 512.  Every
    pixel draws its own dj and loc, so a unit read at another's place
    shows."""
    taps, djs, locs, quads = gather_variants.make_inputs(seed=1, grid=grid)
    rng = np.random.default_rng(2)
    ins = (taps,) + tuple(torch.as_tensor(a, device=card["dev"]) for a in (
        rng.integers(0, 6, djs.shape, dtype=np.int32),
        rng.integers(0, 254, locs.shape, dtype=np.int32), quads.numpy()))
    before = _build.MODE_LAUNCHES.get(f"gather_bench/{variant}", 0)
    got = gather_variants.run(variant, *ins)
    assert _build.MODE_LAUNCHES[f"gather_bench/{variant}"] == before + 1
    want = gather_variants.run_plain(variant, *ins)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_apd_pass_with_a_label_map_on_the_card(card):
    """REFINE_ITER with use_APD, geometric consistency and a label map,
    on the card: finite depths, and K4 and K3's parity mode launched."""
    from dvpmvs_torch.config import PixelState, PMDynamic, PMStatic, RunState
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.rng import TorchDraws
    c = card
    scene, dev = c["scene"], c["dev"]
    dyn = PMDynamic.create(depth_min=float(c["ref"].depth_min),
                           depth_max=float(c["ref"].depth_max))
    st = PMStatic(state=RunState.REFINE_ITER, num_src=V, max_iterations=1,
                  cost_backend="fused", use_APD=True, geom_consistency=True,
                  rotate_time=2, use_label=True)
    xs, ys = _grid(H, W, dev)
    weak = torch.full((H, W), int(PixelState.STRONG), dtype=torch.int8,
                      device=dev)
    weak[10:30, 40:120] = int(PixelState.WEAK)
    label = ((xs // 20) + 8 * (ys // 16) + 1).to(torch.int32)
    sel = torch.ones((H, W, V), dtype=torch.bool, device=dev)
    _build.reset_launches()
    out = run_pass(
        scene.images[0], scene.images[1:], c["ref"], c["src"], st, dyn,
        TorchDraws(0), init_plane_world=torch.cat(
            [torch.as_tensor(scene.gt_normal[0], device=dev),
             c["depth"][..., None]], -1),
        init_sel_views=sel, init_weak=weak,
        src_depths=scene.gt_depth[1:], label=label)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.depth).all())
    assert _build.LAUNCHES["anchor"] == 2
    assert _build.MODE_LAUNCHES["geom/parity"] == 4


def test_warp_and_tap_passes_on_the_card(card):
    """REFINE_ITER with the warp backend (its NCC kernel once for every
    batch it evaluates, with every plane, and K5 alone never; K3 per view
    in its sweeps), without and with use_APD (K4 on the full
    grid), and with use_APD and anchor_taps=3 (K4's tap mode): finite
    depths."""
    from dvpmvs_torch.config import PixelState, PMDynamic, PMStatic, RunState
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.kernels import ncc
    from dvpmvs_torch.rng import TorchDraws
    c = card
    scene, dev = c["scene"], c["dev"]
    dyn = PMDynamic.create(depth_min=float(c["ref"].depth_min),
                           depth_max=float(c["ref"].depth_max))
    weak = torch.full((H, W), int(PixelState.STRONG), dtype=torch.int8,
                      device=dev)
    weak[10:30, 40:120] = int(PixelState.WEAK)
    init = dict(init_plane_world=torch.cat(
        [torch.as_tensor(scene.gt_normal[0], device=dev),
         c["depth"][..., None]], -1),
        init_sel_views=torch.ones((H, W, V), dtype=torch.bool, device=dev),
        init_weak=weak, src_depths=scene.gt_depth[1:])
    apd = dict(use_APD=True, rotate_time=2, use_label=False)
    for st in (PMStatic(state=RunState.REFINE_ITER, num_src=V,
                        max_iterations=1, cost_backend="warp",
                        geom_consistency=True),
               PMStatic(state=RunState.REFINE_ITER, num_src=V,
                        max_iterations=1, cost_backend="warp",
                        geom_consistency=True, **apd),
               PMStatic(state=RunState.REFINE_ITER, num_src=V,
                        max_iterations=1, cost_backend="fused",
                        geom_consistency=True, anchor_taps=3, **apd)):
        _build.reset_launches()
        planes = dict(ncc.PLANES_EVALUATED)
        batches = dict(ncc.BATCHES_EVALUATED)
        kernel_planes = warp_fused.KERNEL_PLANES["ncc"]
        out = run_pass(scene.images[0], scene.images[1:], c["ref"],
                       c["src"], st, dyn, TorchDraws(0), **init)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out.depth).all())
        if st.cost_backend == "warp":
            assert _build.MODE_LAUNCHES["warp/ncc"] == (
                ncc.BATCHES_EVALUATED["warp"] - batches["warp"]) > 0
            assert warp_fused.KERNEL_PLANES["ncc"] - kernel_planes == (
                ncc.PLANES_EVALUATED["warp"] - planes["warp"])
            assert _build.MODE_LAUNCHES.get("warp/field", 0) == 0
            assert _build.MODE_LAUNCHES["geom/per view"] > 0
        if st.use_APD:
            mode = "taps" if st.anchor_taps > 1 else "single tap"
            assert _build.MODE_LAUNCHES[f"anchor/{mode}"] == 2


@pytest.mark.parametrize("K", [1, 61])
@pytest.mark.parametrize("mode", ["fold", "per view", "parity0",
                                  "parity1"])
def test_geom_kernel_ragged_shape(ragged, mode, K):
    """K3 at 37 x 101 (no whole 128-pixel block; an odd width, so one
    color's last column is the padding column x = W), K = 1 or 61
    disparity steps around the ground truth (the far steps give negative
    and infinite depths), in each mode."""
    r = ragged
    dev = r["dev"]
    gctx = build_geom_context(r["src_depths"], r["ref"], r["src"])
    Hr, Wr = r["depth"].shape
    par = int(mode[-1]) if mode.startswith("parity") else None
    depth = r["depth"] if par is None else pack_parity(r["depth"], par)
    fxbl = float(r["ref"].fx) * 0.3
    ks = torch.arange(K, dtype=torch.float32, device=dev) - K // 2
    dstack = (fxbl / (fxbl / depth[None] + ks[:, None, None])).contiguous()
    fold = mode == "fold"
    vw = torch.rand((Hr, Wr, V), generator=torch.Generator(
        device=dev).manual_seed(K), device=dev) if fold else None
    kw = dict(vweights=vw, fold=fold, parity=par)
    key = "geom/" + ("fold" if fold else "per view" if par is None
                     else "parity")
    before = _build.MODE_LAUNCHES.get(key, 0)
    got = geom_fused.geom_cost(gctx, dstack, **kw)
    assert _build.MODE_LAUNCHES[key] == before + 1
    want = geom_fused.geom_cost_plain(gctx, dstack, **kw)
    Wp = Wr if par is None else (Wr + 1) // 2
    assert tuple(got.shape) == ((K, Hr, Wp) if fold else (K, Hr, Wp, V))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    _agree(got, want)


def _k4_random_args(dev, img, ref, ctx, plane, K, A, S, n_extra, fill,
                    seed):
    """K4's arguments at K random anchors per pixel (A of them), some
    invalid, views unseen at random and view 1 unseen by every anchor of
    pixels 0-9; the last ``fill`` entries are fill (no usable anchor); slot
    planes near the ground truth with w = 0, NaN and infinite planes at
    some pixels; random tap words with ``n_extra``."""
    Hs, Ws = img.shape[-2:]
    Vs = ctx.src_imgs.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device=dev)
    ax = (rand(A, K) * Ws).floor().to(torch.int32)
    ay = (rand(A, K) * Hs).floor().to(torch.int32)
    rax = (ax.float() - ref.cx) / ref.fx
    ray = (ay.float() - ref.cy) / ref.fy
    ref_a = img[0].reshape(-1)[(ay * Ws + ax).long()]
    w_col = torch.exp(-torch.abs(ref_a - 255.0 * rand(A, K)) / 18.0)
    vbits = torch.zeros((A, K), dtype=torch.int32, device=dev)
    for v in range(Vs):
        vbits |= (rand(A, K) < 0.85).to(torch.int32) << v
    vbits *= (rand(A, K) < 0.9).to(torch.int32)
    vbits[:, :10] &= ~2
    vbits[:, K - fill:] = 0
    pix = (rand(S, K) * Hs * Ws).floor().long()
    planes = plane.reshape(-1, 4)[pix]
    planes[..., 3] *= 1.0 + 0.1 * (rand(S, K) - 0.5)
    planes[0, ::3, 3] = 0.0
    planes[1, ::4] = float("nan")
    planes[2, ::5, 0] = float("inf")
    words, inv_f = None, None
    if n_extra:
        words = torch.randint(0, 2 ** 24, (Vs, n_extra, A, K), generator=g,
                              device=dev, dtype=torch.int32)
        inv_f = (ctx.inv_fx, ctx.inv_fy)
    return (ctx.src_imgs, ctx.M, ctx.b, ctx.src_wh,
            anchor_fused.slot_q(planes), rax.contiguous(), ray.contiguous(),
            ref_a.contiguous(), w_col.contiguous(), vbits.contiguous(),
            words, inv_f)


def _k4_check(args, fixed_kv=None):
    """K4 against its plain version: has equal, costs by _agree, and
    cost 0 / has false exactly where ``fixed_kv`` [K, V]."""
    mode = "anchor/taps" if args[10] is not None else "anchor/single tap"
    before = _build.MODE_LAUNCHES.get(mode, 0)
    got = anchor_fused.anchor_slot_costs(*args)
    assert _build.MODE_LAUNCHES[mode] == before + 1
    want = anchor_fused.anchor_slot_costs_plain(*args)
    assert torch.equal(got.has_anchors, want.has_anchors)
    assert torch.equal(torch.isnan(got.cost), torch.isnan(want.cost))
    _agree(got.cost, want.cost)
    if fixed_kv is not None:
        fx = fixed_kv[None].expand_as(got.cost)
        assert bool((got.cost[fx] == 0.0).all())
        assert not bool(got.has_anchors[fx].any())
    return got


@pytest.mark.parametrize("n_extra", [0, 1, 2])
@pytest.mark.parametrize("A", [7, 13])
def test_anchor_kernel_degenerate_planes(ragged, A, n_extra):
    """K4 with A not a multiple of 4 (groups of 4 and 3, or 5 and 4 and 4),
    a ragged K = 333 whose last 41 entries are fill, 10 slot planes of
    which three are degenerate (w = 0, NaN, infinite n) at some pixels."""
    r = ragged
    ctx = build_cost_context(r["img"][0], r["img"][1:], r["ref"], r["src"],
                             5.0, 3.0, backend="fused",
                             color_only_weights=True)
    args = _k4_random_args(r["dev"], r["img"], r["ref"], ctx, r["plane"],
                           333, A, 10, n_extra, 41, seed=A + n_extra)
    vbits = args[9]
    fixed = torch.stack([((vbits >> v) & 1).sum(0) == 0 for v in range(V)],
                        -1)
    assert bool(fixed[-41:].all()) and bool(fixed[:10, 1].all())
    got = _k4_check(args, fixed)
    assert bool(got.has_anchors.any())


@pytest.mark.parametrize("n_extra", [0, 2])
def test_anchor_kernel_band_compaction(card, n_extra):
    """K4 as the weak half-iteration calls it: a 10 % random weak mask,
    the anchors find_anchors gives it on the ground-truth planes, compacted
    on one color by _band_compact at the path's budget (half the packed
    grid: a ragged suffix of fill entries), the bench scene's tap words."""
    from dvpmvs_torch.config import PixelState
    from dvpmvs_torch.engine.patchmatch import _band_compact, _weak_budget
    from dvpmvs_torch.kernels.deformable import (anchor_fields_at,
                                                 gather_tap_words,
                                                 pack_tap_fields)
    from dvpmvs_torch.kernels.weak import find_anchors, patch_candidates
    from dvpmvs_torch.rng import TorchDraws
    c = card
    dev, ref = c["dev"], c["ref"]
    g = torch.Generator(device=dev).manual_seed(3)
    weak = torch.where(torch.rand((H, W), generator=g, device=dev) < 0.1,
                       int(PixelState.WEAK), int(PixelState.STRONG)
                       ).to(torch.int8)
    plane = c["planes"][0]
    anchors = find_anchors(weak, plane, ref, TorchDraws(0, dev), (),
                           rotate_time=4, depth_range=float(
                               ref.depth_max - ref.depth_min))
    ctx = build_cost_context(c["img"][0], c["img"][1:], ref, c["src"], 5.0,
                             3.0, backend="fused", color_only_weights=True)
    sel = torch.ones((H, W, V), dtype=torch.bool, device=dev)
    pk1 = lambda a, axis=0: pack_parity(a, 1, axis)
    weak_pk = pk1(weak == PixelState.WEAK)
    SZ = weak_pk.numel()
    flat_idx, ok_k = _band_compact(weak_pk, _weak_budget(SZ, 0.5))
    assert 0 < int(ok_k.sum()) < ok_k.numel() and not bool(ok_k[-1])
    gidx = torch.clamp(flat_idx, max=SZ - 1)
    af = anchor_fields_at(ctx, anchors, sel, c["img"][0], 3.0, pk1, gidx)
    planes = pk1(plane).reshape(SZ, 4)[gidx][None].repeat(10, 1, 1)
    planes[..., 3] *= 1.0 + 0.1 * (torch.rand(planes.shape[:2], generator=g,
                                              device=dev) - 0.5)
    words = None
    if n_extra:
        tap_fields = pack_tap_fields(c["img"][0], patch_candidates(
            c["img"][0], sel, 3.0, weak_radius=5), n_extra)
        words = gather_tap_words(tap_fields, af,
                                 pk1(c["img"][0]).reshape(-1)[gidx], 3.0, W,
                                 n_extra)
    args = anchor_fused.kernel_args(ctx, planes, af, ok_k, words)
    got = _k4_check(args, (~ok_k)[:, None].expand(-1, V))
    assert bool(got.has_anchors[:, ok_k].any())


def test_scene_command_on_the_card(card, tmp_path):
    """``scene <folder>`` on the card (its default device): a 4-view 48x160
    scene, one geometric pass, to a non-empty APD.ply, launching K1-K3."""
    from dvpmvs_torch.cli.run import main as cli
    from dvpmvs_torch.io import read_ply
    from dvpmvs_torch.utils.synthetic import write_scene_dir
    folder = write_scene_dir(make_scene(num_views=4, height=H, width=W,
                                        seed=2), tmp_path / "dense")
    _build.reset_launches()
    assert cli(["scene", str(folder), "--geometric-passes", "1",
                "--iterations", "2"]) == 0
    for name in ("ncc_fused", "sweep", "geom"):
        assert _build.LAUNCHES.get(name, 0) > 0, name
    pts, cols = read_ply(folder / "APD" / "APD.ply")
    assert len(pts) > 0 and np.isfinite(pts).all()
    assert cols.shape == pts.shape


def test_pair_consistency_on_the_card_matches_the_cpu(card):
    """The fusion's pair test on the card against its CPU run on the same
    noisy ground truth: nearest pixels and validity equal at >= 99.9 % of
    the pixels, err / angle within 1e-4 and rdd within 1e-6 where the
    pixels agree (the CPU's arccos and hypot round differently)."""
    from dvpmvs_torch.fusion import fuse
    scene = card["scene"]
    rng = np.random.default_rng(1)
    depth = [torch.as_tensor((scene.gt_depth[v] * (
        1 + 3e-4 * rng.standard_normal((H, W)))).astype(np.float32))
        for v in (0, 1)]
    normal = [torch.as_tensor((scene.gt_normal[v] @ scene.cameras[v].R
                               .numpy()).astype(np.float32)) for v in (0, 1)]
    mask = torch.zeros((H, W), dtype=torch.uint8)
    mask[10:20, 5:60] = 1
    args = (depth[0], normal[0], scene.cameras[0], depth[1], normal[1],
            scene.cameras[1], mask)
    want = fuse._pair_consistency(*args)
    got = fuse._pair_consistency(*(
        a.to(card["dev"]) for a in args))
    got = [g.cpu() for g in got]
    same = (got[3] == want[3]) & (got[4] == want[4])
    assert float(same.float().mean()) >= 0.999
    assert float((got[5] == want[5]).float().mean()) >= 0.999
    for k, tol in ((0, 1e-4), (1, 1e-6), (2, 1e-4)):
        assert float(torch.abs(got[k] - want[k])[same].max()) <= tol, k
    assert float(got[5].float().mean()) > 0.5


def test_depth_anything_on_the_card_matches_the_cpu(card):
    """The DA-V2 prior of the three-block test config, one model on the
    card and on the CPU from the same state dict: the 0..255 maps within
    bf16 noise (median |d| <= 1, max |d| <= 8, correlation >= 0.9995, the
    CPU tests' bound against Flax; cuBLAS and oneDNN sum bf16 products in
    other orders)."""
    from dvpmvs_torch.priors import convert as t_convert
    from dvpmvs_torch.priors import depth_anything as t_da
    cfg = t_da.DAConfig(embed_dim=64, depth=3, num_heads=2,
                        out_indices=(0, 1, 2, 2), dpt_features=16,
                        dpt_out_channels=(8, 16, 24, 32))
    sd = {k: torch.as_tensor(np.full_like(v, 0.5) if k.endswith(".gamma")
                             else v)
          for k, v in t_convert.random_state_dict(cfg, seed=3).items()}
    img = np.random.default_rng(5).uniform(0, 255, (40, 52)).astype(
        np.float32)
    maps = []
    for dev in ("cpu", card["dev"]):
        model = t_da.DepthAnythingV2(cfg)
        model.load_state_dict(sd)
        maps.append(t_da.infer_relative_depth(model.to(dev).eval(), img))
    want, got = maps
    d = np.abs(got.astype(np.float64) - want)
    assert np.isfinite(got).all() and got.shape == (40, 52)
    assert np.median(d) <= 1.0 and d.max() <= 8.0
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.9995


def test_prior_and_two_round_scene_on_the_card(card, tmp_path):
    """``prior --tiny`` then ``scene --mono-prior`` over two rounds on the
    card (their default device): a 4-view 48x160 band scene with sfm/
    points, round 1 with computed label maps; launches K1-K4, and K3's
    parity mode in round 1's APD pass."""
    from dvpmvs_torch.cli.run import main as cli
    from dvpmvs_torch.io import read_ply
    from dvpmvs_torch.utils.synthetic import write_scene_dir
    folder = write_scene_dir(make_scene(num_views=4, height=H, width=W,
                                        seed=6, weak_band=True),
                             tmp_path / "dense", with_sfm=True,
                             sfm_points=80)
    assert cli(["prior", str(folder), "--tiny"]) == 0
    _build.reset_launches()
    assert cli(["scene", str(folder), "--mono-prior", "--max-base-size",
                str(W // 2), "--full-res-round", "--geometric-passes", "1",
                "--iterations", "2"]) == 0
    for name in ("ncc_fused", "sweep", "geom", "anchor"):
        assert _build.LAUNCHES.get(name, 0) > 0, name
    assert _build.MODE_LAUNCHES.get("geom/parity", 0) > 0
    pts, _ = read_ply(folder / "APD" / "APD.ply")
    assert len(pts) > 0 and np.isfinite(pts).all()


def test_exact_oracle_on_the_card_matches_the_cpu(card):
    """The exact deformable oracle on the card (K1 for the center window)
    against its CPU run on the same context, anchors, candidates and
    plane field (a band of the ground truth 10 % too far).  The CPU run
    takes its tap weights' exp from the card (the two devices' exp round
    differently, and the oracle's near-zero variances amplify a last
    bit): then every other operation rounds alike, and the bound is the
    kernel tests' measure at 1e-5."""
    import dataclasses

    from dvpmvs_torch import fmath
    from dvpmvs_torch.config import PixelState
    from dvpmvs_torch.kernels import deformable, weak
    from dvpmvs_torch.kernels.weak import AnchorResult
    from dvpmvs_torch.rng import TorchDraws
    scene, dev = card["scene"], card["dev"]
    ref = scene.cameras[0]
    img = torch.as_tensor(scene.images)
    ctx = build_cost_context(img[0], img[1:], ref,
                             stack_cameras(scene.cameras[1:]), 5.0, 3.0,
                             backend="fused", color_only_weights=True)
    xs, ys = _grid(H, W, "cpu")
    band = torch.zeros((H, W), dtype=torch.bool)
    band[12:30, 30:130] = True
    depth = torch.as_tensor(scene.gt_depth[0])
    plane = plane_from_normal_depth(
        torch.as_tensor(scene.gt_normal[0]),
        torch.where(band, depth * 1.1, depth), xs, ys, ref)
    wk = torch.where(band, int(PixelState.WEAK),
                     int(PixelState.STRONG)).to(torch.int8)
    anchors = weak.find_anchors(wk, plane, ref, TorchDraws(0, "cpu"), (),
                                rotate_time=2)
    sel = torch.as_tensor(np.random.default_rng(2).uniform(
        size=(H, W, V)) < 0.8)
    patch_off = weak.patch_candidates(img[0], sel, 3.0)
    args = (plane, anchors, patch_off, sel, img[0])
    exp = fmath.exp
    try:
        fmath.exp = lambda x: exp(x.to(dev)).to(x.device)
        want = deformable.deformable_cost_exact(ctx, *args, 3.0)
    finally:
        fmath.exp = exp
    to = lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a
    ctx_d = dataclasses.replace(ctx, **{
        f.name: to(getattr(ctx, f.name)) for f in dataclasses.fields(ctx)})
    _build.reset_launches()
    got = deformable.deformable_cost_exact(
        ctx_d, plane.to(dev), AnchorResult(*(to(a) for a in anchors)),
        *(to(a) for a in args[2:]), 3.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ncc_fused"] == 1
    assert bool(anchors.valid.any())
    _agree(got.cpu(), want, bound=1e-5)
