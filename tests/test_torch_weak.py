"""The port's weak-pixel machinery (dvpmvs_torch/kernels/weak.py) against
the JAX package on the same inputs, at 32x48 with rotate_time=2, with and
without a label map: nearest strong pixels, label-boundary distances, edge
complexity, detail demotion, the anchor search with its RANSAC vote
(``find_anchors``) and the per-iteration fit plane with its radius map
(``ransac_fit_plane``).  Both packages draw the same numbers (the JAX keys,
through ``JaxDraws``).

The JAX anchor search and fit run op by op (``jax.disable_jit``): the
triad anchors lie on their own fitted plane, so their distances to it are
rounding noise that orders them, and any fusion (a jit, or the compiled
body of ``lax.scan``) reorders some of them.  Op by op the two packages
round identically.  The integer-valued functions run under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import JaxDraws, np_, t_camera

from dvpmvs.config import PixelState
from dvpmvs.geometry.transforms import dist_to_origin
from dvpmvs.kernels import weak as j_weak
from dvpmvs.priors.edges import edge_segment
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch import convert
from dvpmvs_torch.kernels import weak as t_weak

H, W, V = 32, 48, 3
ROTATE = 2
THRESH = np.float32(0.00875)        # ransac_threshold of round 1


@pytest.fixture(scope="module")
def setup():
    """A band scene's ground-truth planes with 0.2 % depth noise, a weak map
    (a 30 % random share plus an injected block, the rest strong or
    unknown), its Canny edges and a label map with a 0 region."""
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=6,
                       weak_band=True)
    ref = scene.cameras[0]
    rng = np.random.default_rng(11)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    n = scene.gt_normal[0]
    d = scene.gt_depth[0] * (1.0 + 0.002 * rng.standard_normal((H, W))
                             ).astype(np.float32)
    w = np.asarray(dist_to_origin(jnp.asarray(n), jnp.asarray(xs),
                                  jnp.asarray(ys), jnp.asarray(d), ref))
    plane = np.concatenate([n, w[..., None]], -1).astype(np.float32)
    u = rng.uniform(size=(H, W))
    weak = np.where(u < 0.3, PixelState.WEAK,
                    np.where(u < 0.35, PixelState.UNKNOWN,
                             PixelState.STRONG)).astype(np.int8)
    weak[10:20, 12:30] = PixelState.WEAK
    edge = edge_segment(0, scene.images[0], mode=0, use_canny=True) > 0
    label = ((xs // 12) + 4 * (ys // 11)).astype(np.int32) + 1
    label[20:, :10] = 0
    drange = np.float32(ref.depth_max) - np.float32(ref.depth_min)
    return dict(ref=ref, t_ref=t_camera(ref), plane=plane, weak=weak,
                edge=edge, label=label, drange=float(drange))


def _t(a):
    return torch.as_tensor(np.array(a))


def test_nearest_strong_matches_jax(setup):
    jc, jv = jax.jit(j_weak.nearest_strong)(jnp.asarray(setup["weak"]))
    tc, tv = t_weak.nearest_strong(_t(setup["weak"]))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(np_(tc), np.asarray(jc))
    np.testing.assert_array_equal(np_(tv), np.asarray(jv))


def test_label_boundary_distance_matches_jax(setup):
    want = np.asarray(jax.jit(j_weak.label_boundary_distance)(
        jnp.asarray(setup["label"])))
    got = np_(t_weak.label_boundary_distance(_t(setup["label"])))
    assert got.shape == (8, H, W)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_edge_complexity_matches_jax(setup):
    want = np.asarray(jax.jit(j_weak.edge_complexity, static_argnums=1)(
        jnp.asarray(setup["edge"]), 5))
    got = np_(t_weak.edge_complexity(_t(setup["edge"]), 5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_label", [False, True])
def test_demote_detail_matches_jax(setup, with_label):
    lab = setup["label"] if with_label else None
    want = np.asarray(j_weak.demote_detail(
        jnp.asarray(setup["weak"]), jnp.asarray(setup["edge"]),
        None if lab is None else jnp.asarray(lab)))
    got = np_(t_weak.demote_detail(_t(setup["weak"]), _t(setup["edge"]),
                                   None if lab is None else _t(lab)))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def _anchor_args(s, with_label):
    """(jax kwargs, port kwargs) of find_anchors beyond the weak map."""
    e = s["edge"]
    lab = s["label"] if with_label else None
    j_lab = None if lab is None else jnp.asarray(lab)
    kw_j = dict(rotate_time=ROTATE, edge=jnp.asarray(e),
                complexity=jax.jit(j_weak.edge_complexity, static_argnums=1)(
                    jnp.asarray(e), 5),
                ransac_threshold=jnp.float32(THRESH),
                depth_range=jnp.float32(s["drange"]), label=j_lab,
                label_dist=None if lab is None
                else jax.jit(j_weak.label_boundary_distance)(j_lab))
    t_lab = None if lab is None else _t(lab)
    kw_t = dict(rotate_time=ROTATE, edge=_t(e),
                complexity=t_weak.edge_complexity(_t(e), 5),
                ransac_threshold=float(THRESH), depth_range=s["drange"],
                label=t_lab, label_dist=None if lab is None
                else t_weak.label_boundary_distance(t_lab))
    return kw_j, kw_t


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_label", "label"])
def anchors(request, setup):
    """find_anchors of both packages from the same weak map, planes and
    JAX key."""
    key = jax.random.PRNGKey(3)
    kw_j, kw_t = _anchor_args(setup, request.param)
    with jax.disable_jit():
        want = j_weak.find_anchors(jnp.asarray(setup["weak"]),
                                   jnp.asarray(setup["plane"]),
                                   setup["ref"], key, **kw_j)
    got = t_weak.find_anchors(_t(setup["weak"]), _t(setup["plane"]),
                              setup["t_ref"], JaxDraws(key), (), **kw_t)
    return want, got, request.param


def test_find_anchors_matches_jax(anchors):
    """Measured: coords, valid and reliable equal at every entry, with and
    without a label map, on an AMD EPYC host; the port's search on a second
    host (an H100 machine's CPU, torch 2.11) from the same inputs and draws
    equals the first host's JAX search at every entry too
    (tests/torch_host_agreement.py).  The port's square roots are
    correctly rounded, as XLA's (``dvpmvs_torch.fmath``); with PyTorch's
    own CPU sqrt, an ulp off at a host-dependent share of inputs, coords
    agreed at 99.956 % on one host and 98.9 % on another (near-equal anchor
    distances ordered the other way).  Every other op of the search is
    IEEE arithmetic, so the bound is equality."""
    want, got, _ = anchors
    assert tuple(got.coords.shape) == (t_weak.NUM_ANCHORS, H, W, 2)
    assert got.coords.dtype == torch.int32
    for name in ("coords", "valid", "reliable"):
        same = float((np_(getattr(got, name))
                      == np.asarray(getattr(want, name))).mean())
        print(f"find_anchors {name}: equal at {same:.5f}")
        assert same == 1.0, (name, same)
    # the vote found planes: the comparison is not vacuous
    assert float(np.asarray(want.reliable).mean()) > 0.1


def test_ransac_fit_plane_matches_jax(setup, anchors):
    """Measured: fit planes within 1e-4 and radius maps equal at every
    pixel in both cases; the bounds are 99.5 %."""
    want_a, _, with_label = anchors
    key = jax.random.PRNGKey(8)
    e = jnp.asarray(setup["edge"])
    lab = setup["label"] if with_label else None
    j_ld = None if lab is None else jax.jit(j_weak.label_boundary_distance)(
        jnp.asarray(lab))
    j_ed = jax.jit(j_weak.edge_ray_distance)(e)
    with jax.disable_jit():
        j_fit, j_rad = j_weak.ransac_fit_plane(
            want_a, jnp.asarray(setup["plane"]), jnp.asarray(setup["weak"]),
            setup["ref"], key, use_radius=True, strong_radius=5,
            edge_dist=j_ed, label_dist=j_ld)
    t_ld = None if lab is None else t_weak.label_boundary_distance(_t(lab))
    t_fit, t_rad = t_weak.ransac_fit_plane(
        convert.anchors(want_a, device="cpu"), _t(setup["plane"]),
        _t(setup["weak"]), setup["t_ref"], JaxDraws(key), (),
        use_radius=True, strong_radius=5,
        edge_dist=t_weak.edge_ray_distance(_t(setup["edge"])),
        label_dist=t_ld)
    fit_ok = float((np.abs(np_(t_fit) - np.asarray(j_fit)) <= 1e-4)
                   .all(-1).mean())
    rad_ok = float((np_(t_rad) == np.asarray(j_rad)).mean())
    print(f"ransac_fit_plane: fit within 1e-4 at {fit_ok:.5f}, "
          f"radius equal at {rad_ok:.5f}")
    assert fit_ok >= 0.995 and rad_ok >= 0.995, (fit_ok, rad_ok)
    # planes were fitted at a share of the weak pixels
    assert float((np.asarray(j_fit)[..., :3] != 0).any(-1).mean()) > 0.1


def _apd_problem():
    """A 32x48 band scene's FIRST_INIT (port, CPU) with its textureless
    band marked WEAK, and a label map with a 0 region."""
    from dvpmvs_torch.config import PMDynamic, PMStatic, RunState
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.rng import TorchDraws
    from dvpmvs_torch.utils.synthetic import make_scene as t_make_scene
    scene = t_make_scene(num_views=V + 1, height=H, width=W, seed=6,
                         weak_band=True)
    ref, src = scene.cameras[0], stack_cameras(scene.cameras[1:])
    dyn = PMDynamic.create(depth_min=float(ref.depth_min),
                           depth_max=float(ref.depth_max))
    base = PMStatic(num_src=V, max_iterations=1, cost_backend="fused",
                    rotate_time=ROTATE)
    first = run_pass(scene.images[0], scene.images[1:], ref, src, base, dyn,
                     TorchDraws(0, device="cpu"), device="cpu")
    weak = first.weak.clone()
    weak[10:20, 8:40] = PixelState.WEAK
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    label = ((xs // 12) + 4 * (ys // 11) + 1).astype(np.int32)
    label[20:, :10] = 0
    init = dict(init_plane_world=torch.cat(
        [first.normal_world, first.depth[..., None]], -1),
        init_sel_views=first.sel_views, init_weak=weak)
    run = lambda st, **kw: run_pass(
        scene.images[0], scene.images[1:], ref, src, st, dyn,
        TorchDraws(1, device="cpu"), device="cpu", **init, **kw)
    return scene, base.replace(use_APD=True), run, label


@pytest.mark.parametrize("state", ["REFINE_INIT", "REFINE_ITER"])
def test_apd_pass_with_a_label_map_runs(state):
    """run_pass with use_APD and a label map (the label branch of the
    anchor search, label demotion, label-bounded radius): finite depths of
    the right shape, no budget overflow, and the weak half committed."""
    from dvpmvs_torch.config import RunState
    scene, st, run, label = _apd_problem()
    st = st.replace(state=RunState[state], use_label=True, use_detail=True,
                    geom_consistency=state == "REFINE_ITER")
    extra = (dict(src_depths=scene.gt_depth[1:])
             if state == "REFINE_ITER" else {})
    out = run(st, label=label, **extra)
    assert tuple(out.depth.shape) == (H, W)
    assert bool(torch.isfinite(out.depth).all())
    assert int(out.weak_overflow) == 0
    no_label = run(st.replace(use_label=False), **extra)
    # the label map changes the anchors, so the weak region's depths move
    assert not torch.equal(out.depth, no_label.depth)


@pytest.mark.parametrize("taps", [2, 3])
def test_apd_pass_with_anchor_taps_runs(taps):
    """run_pass with use_APD and the sparse-patch taps (anchor_taps 2 or 3,
    K4's tap mode through its plain version): finite depths of the right
    shape, and the taps change the weak region's depths."""
    scene, st, run, _ = _apd_problem()
    out = run(st.replace(anchor_taps=taps))
    assert tuple(out.depth.shape) == (H, W)
    assert bool(torch.isfinite(out.depth).all())
    assert not torch.equal(out.depth, run(st).depth)


@pytest.mark.parametrize("state", ["REFINE_INIT", "REFINE_ITER"])
def test_apd_pass_on_the_warp_backend_runs(state):
    """run_pass with use_APD on the "warp" cost backend (full grid, the
    weak half's centers through the warp-once NCC, the anchor term through
    K4's plain version): finite depths of the right shape, no budget
    overflow, and the weak region's depths differ from the fused pass's."""
    from dvpmvs_torch.config import RunState
    scene, st, run, _ = _apd_problem()
    st = st.replace(state=RunState[state],
                    geom_consistency=state == "REFINE_ITER")
    extra = (dict(src_depths=scene.gt_depth[1:])
             if state == "REFINE_ITER" else {})
    out = run(st.replace(cost_backend="warp"), **extra)
    assert tuple(out.depth.shape) == (H, W)
    assert bool(torch.isfinite(out.depth).all())
    assert int(out.weak_overflow) == 0
    assert not torch.equal(out.depth, run(st, **extra).depth)


@pytest.mark.parametrize("field,value", [("exact_deformable", True),
                                         ("debug_dumps", True)])
def test_apd_modes_not_ported_raise(field, value):
    """Both modes are ported: the exact oracle's pass runs without the
    compaction diagnostic; debug_dumps returns the [61, H, W] sweep curves
    and the anchors as JAX does."""
    _, st, run, _ = _apd_problem()
    out = run(st.replace(**{field: value}))
    assert bool(torch.isfinite(out.depth).all())
    if field == "exact_deformable":
        assert out.weak_overflow is None and out.cost_line is None
    else:
        assert tuple(out.cost_line.shape) == (61, H, W)
        assert tuple(out.anchors_xy.shape[1:]) == (H, W, 2)
        assert out.anchors_valid.shape == out.anchors_xy.shape[:3]
        assert int(out.weak_overflow) >= 0
