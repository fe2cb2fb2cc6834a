"""The sparse-patch tap mode of the anchor term (``PMStatic.anchor_taps``
> 1) against the JAX package on the CPU: the per-view patch candidates, the
tap words, K4's plain tap mode (against JAX's fp32 oracle run op by op and
against the Pallas kernel in interpret mode), and one weak half-iteration
with ``anchor_taps=3`` from the same state and draws.

The u8 weight and ref quantization of the tap words is the semantics JAX's
oracle and kernel share, so both packages build the same words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_anchor_pallas import _setup
from test_torch_support import (JaxDraws, compile_jax, np_, t_camera,
                                t_cameras)

from dvpmvs import config as j_config
from dvpmvs.config import PixelState
from dvpmvs.engine import patchmatch as j_pm
from dvpmvs.engine.state import PMState as JState
from dvpmvs.geometry import stack_cameras
from dvpmvs.geometry.transforms import dist_to_origin
from dvpmvs.kernels import deformable as j_def
from dvpmvs.kernels import weak as j_weak
from dvpmvs.kernels.anchor_pallas import anchor_slot_costs_from_ctx as j_k4
from dvpmvs.kernels.ncc import build_cost_context as j_build_ctx
from dvpmvs.kernels.weak import AnchorResult as JAnchorResult
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch import convert
from dvpmvs_torch.engine import patchmatch as t_pm
from dvpmvs_torch.engine.state import PMState as TState
from dvpmvs_torch.kernels import _build, anchor_fused, deformable, weak
from dvpmvs_torch.kernels.ncc import _grid, build_cost_context
from dvpmvs_torch.rng import fold_in, split

_CTX_FIELDS = ("M", "b", "w_taps", "wref_taps", "sum_w", "sum_wref",
               "sum_wref2", "radius", "rx", "ry", "src_wh")


def _t(a):
    return torch.as_tensor(np.array(a))


def _patch_problem(H=32, W=48, V=3, seed=6):
    """A band scene's reference image with a flat (textureless) block, and
    random selected views."""
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=seed,
                       weak_band=True)
    ref_img = np.array(scene.images[0])
    ref_img[8:16, 10:22] = 100.0
    sel = np.random.default_rng(seed).uniform(size=(H, W, V)) < 0.7
    return scene, ref_img, sel


def test_patch_candidates_match_jax():
    """Offsets equal everywhere, ties (the flat block, empty regions)
    broken as JAX's stable argsort breaks them."""
    _, ref_img, sel = _patch_problem()
    want = np.asarray(j_weak.patch_candidates(
        jnp.asarray(ref_img), jnp.asarray(sel), 3.0, weak_radius=5))
    got = np_(weak.patch_candidates(_t(ref_img), _t(sel), 3.0,
                                    weak_radius=5))
    assert got.shape == want.shape == (3, 8, 32, 48, 2)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    # the flat block has equal weights: the order is the tie-break's
    assert (got[:, :, 10:14, 13:19] != 0).any()
    assert (got == 0).all(-1).any()         # some empty slots


@pytest.mark.parametrize("n_extra", [1, 2])
def test_tap_words_match_jax(n_extra):
    """``pack_tap_fields`` and ``gather_tap_words`` equal JAX's words."""
    H, W, V = 48, 64, 3
    ctx_j, af, _ = _setup(H=H, W=W, V=V, seed=5)
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=5)
    ri = np.asarray(scene.images[0])
    rng = np.random.default_rng(7)
    patch_off = rng.integers(-5, 6, (V, 8, H, W, 2)).astype(np.int8)
    patch_off[:, :, ::7] = 0                       # empties -> fixed grid
    ref_c = rng.uniform(0, 255, af.ax.shape[1]).astype(np.float32)
    want_f = j_def.pack_tap_fields(jnp.asarray(ri), jnp.asarray(patch_off),
                                   n_extra)
    want_w = j_def.gather_tap_words(want_f, af, jnp.asarray(ref_c), 3.0, W,
                                    n_extra)
    got_f = deformable.pack_tap_fields(_t(ri), _t(patch_off), n_extra)
    af_t = deformable.AnchorFields(*(_t(x) for x in af))
    got_w = deformable.gather_tap_words(got_f, af_t, _t(ref_c), 3.0, W,
                                        n_extra)
    np.testing.assert_array_equal(np_(got_f), np.asarray(want_f))
    np.testing.assert_array_equal(np_(got_w), np.asarray(want_w))
    assert got_w.dtype == torch.int32
    assert tuple(got_w.shape) == (V, n_extra) + tuple(af.ax.shape)


@pytest.fixture(scope="module")
def taps_problem():
    """tests/test_anchor_pallas.py's tap-mode setup (48x64, V=3, K=700,
    S=10, two taps per anchor) and its words."""
    H, W, V = 48, 64, 3
    ctx_j, af, planes = _setup(H=H, W=W, V=V, seed=5)
    rng = np.random.default_rng(7)
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=5)
    ri = jnp.asarray(scene.images[0])
    patch_off = rng.integers(-5, 6, (V, 8, H, W, 2)).astype(np.int8)
    patch_off[:, :, ::7] = 0
    tap_fields = j_def.pack_tap_fields(ri, jnp.asarray(patch_off), 2)
    ref_c = jnp.asarray(rng.uniform(0, 255, af.ax.shape[1]).astype(
        np.float32))
    tap_w = j_def.gather_tap_words(tap_fields, af, ref_c, 3.0, W, 2)
    t_ctx = build_cost_context(
        _t(ctx_j.src_imgs[0]), _t(ctx_j.src_imgs),
        t_camera(scene.cameras[0]), t_cameras(scene.cameras[1:V + 1]), 5.0,
        3.0).replace(src_imgs=_t(ctx_j.src_imgs), M=_t(ctx_j.M),
                     b=_t(ctx_j.b), src_wh=_t(ctx_j.src_wh))
    _build.reset_launches()
    af_t = deformable.AnchorFields(*(_t(x) for x in af))
    got = anchor_fused.anchor_slot_costs_from_ctx(
        t_ctx, _t(planes), af_t, tap_words=_t(tap_w))
    assert _build.LAUNCHES["anchor"] == 0
    return dict(ctx_j=ctx_j, t_ctx=t_ctx, af=af, af_t=af_t, planes=planes,
                tap_w=tap_w, got=got, scene=scene)


def test_k4_plain_taps_match_jax_fp32_oracle(taps_problem):
    """K4's plain tap mode vs JAX's ``anchor_cost_term_for_plane`` with the
    same words on an exact-backend context, op by op: has equal; cost within
    1e-4 except at <= 1e-3 of the entries.  Measured: max |d| 1.2e-7."""
    p = taps_problem
    V = 3
    ctx_x = j_build_ctx(p["ctx_j"].src_imgs[0], p["ctx_j"].src_imgs,
                        p["scene"].cameras[0],
                        stack_cameras(p["scene"].cameras[1:V + 1]), 5.0, 3.0,
                        backend="exact", color_only_weights=True)
    ctx_x = ctx_x.replace(M=p["ctx_j"].M, b=p["ctx_j"].b,
                          src_wh=p["ctx_j"].src_wh)
    with jax.disable_jit():
        terms = [j_def.anchor_cost_term_for_plane(ctx_x, pl, p["af"],
                                                  p["tap_w"])
                 for pl in p["planes"]]
    want = jax.tree.map(lambda *x: np.stack(x), *terms)
    got = p["got"]
    np.testing.assert_array_equal(np_(got.has_anchors),
                                  np.asarray(want.has_anchors))
    diff = np.abs(np_(got.cost) - np.asarray(want.cost))
    share = float((diff > 1e-4).mean())
    print(f"K4 plain taps vs JAX fp32 oracle: max {diff.max():.3e} "
          f"share>1e-4 {share:.2e}")
    assert share <= 1e-3, share
    assert float((np_(got.cost) < 2.0).mean()) > 0.5
    # the taps change the term
    no_taps = anchor_fused.anchor_slot_costs_from_ctx(
        p["t_ctx"], _t(p["planes"]), p["af_t"])
    assert not torch.equal(no_taps.cost, got.cost)


def test_k4_plain_taps_vs_jax_pallas_interpret(taps_problem):
    """Against the Pallas kernel's tap mode in interpret mode (u8 packed
    quads, incremental tap homography): has equal; the costs agree by
    distribution: median |d| <= 2e-3, >= 90 % within 0.01.  Measured:
    median 6.0e-4, 98.9 % within 0.01, mean 1.4e-3 (single tap: 4.2e-4,
    96.8 %, 2.1e-3)."""
    p = taps_problem
    want = j_k4(p["ctx_j"], p["planes"], p["af"], tap_words=p["tap_w"],
                interpret=True)
    got = p["got"]
    np.testing.assert_array_equal(np_(got.has_anchors),
                                  np.asarray(want.has_anchors))
    diff = np.abs(np_(got.cost) - np.asarray(want.cost))
    med = float(np.median(diff))
    within = float((diff <= 0.01).mean())
    print(f"K4 plain taps vs Pallas interpret: median {med:.3e} "
          f"share<=0.01 {within:.3f} mean {diff.mean():.3e}")
    assert med <= 2e-3, med
    assert within >= 0.9, within


def test_weak_half_iteration_with_taps_matches_jax():
    """One weak half-iteration (color 0) of REFINE_ITER with
    ``anchor_taps=3`` on exact backends (no geom term), JAX's
    ``_propagate_color_weak`` with ``tap_fields`` against the port's, from
    one state, anchor set, fit plane and the same draws: planes within 1e-4
    at >= 99 % of the color's weak pixels.  The state is the ground truth
    with a random 30 % of the pixels and the textureless band weak, their
    planes 25 % too far.  Measured: 371 weak pixels of color 0, 255 of
    them moved; planes and costs within 1e-4 at every one."""
    H, W, V = 32, 48, 3
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=6,
                       weak_band=True)
    ref = scene.cameras[0]
    src_cams = stack_cameras(scene.cameras[1:])
    ref_t, src_t = t_camera(ref), t_cameras(scene.cameras[1:])
    ref_img, src_imgs = scene.images[0], scene.images[1:]
    base = j_config.PMStatic(num_src=V, max_iterations=1,
                             cost_backend="exact", use_label=False)
    st, dyn = j_config.round_pass_params(1, 2, 1, base,
                                         float(ref.depth_min),
                                         float(ref.depth_max))
    st = st.replace(anchor_taps=3)
    static_t, dyn_t = convert.static_params(st), convert.dynamic_params(dyn)
    draws = JaxDraws(jax.random.PRNGKey(0))
    xs, ys = _grid(H, W, "cpu")
    rx = (xs - ref_t.cx) / ref_t.fx
    ry = (ys - ref_t.cy) / ref_t.fy
    parity = (xs.to(torch.int32) + ys.to(torch.int32)) % 2
    rng = np.random.default_rng(3)
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    n = scene.gt_normal[0]
    w = np.asarray(dist_to_origin(jnp.asarray(n), jnp.asarray(gx),
                                  jnp.asarray(gy),
                                  jnp.asarray(scene.gt_depth[0]), ref))
    plane = np.concatenate([n, w[..., None]], -1).astype(np.float32)
    weak_np = np.where(rng.uniform(size=(H, W)) < 0.3, PixelState.WEAK,
                    PixelState.STRONG).astype(np.int8)
    weak_np[10:22, 8:40] = PixelState.WEAK
    plane = np.where((weak_np == PixelState.WEAK)[..., None],
                     plane * np.float32([1.0, 1.0, 1.0, 1.25]), plane)
    sel = rng.uniform(size=(H, W, V)) < 0.8
    state_t = TState(plane=_t(plane), cost=torch.ones((H, W)),
                     sel_views=_t(sel), view_weights=torch.zeros((H, W, V)),
                     weak=_t(weak_np), radius=torch.zeros((H, W)))
    anchors = weak_find(weak_np, plane, ref_t, draws, st, dyn_t)
    path_it = fold_in(split((), 3, 2), 0)
    fit, _ = weak.ransac_fit_plane(anchors, _t(plane), _t(weak_np), ref_t,
                                   draws, fold_in(path_it, 3))
    ctx_j, ctx_yzl_j = (j_build_ctx(
        jnp.asarray(ref_img), jnp.asarray(src_imgs), ref, src_cams,
        dyn.sigma_spatial, dyn.sigma_color, strong_radius=5,
        backend="exact", color_only_weights=only) for only in (False, True))
    ctx_t, ctx_yzl_t = (build_cost_context(
        _t(ref_img), _t(src_imgs), ref_t, src_t, dyn_t.sigma_spatial,
        dyn_t.sigma_color, strong_radius=5, backend="exact",
        color_only_weights=only).replace(
            **{f: _t(getattr(cj, f)) for f in _CTX_FIELDS})
        for only, cj in ((False, ctx_j), (True, ctx_yzl_j)))
    tf_j = j_def.pack_tap_fields(jnp.asarray(ref_img), j_weak.patch_candidates(
        jnp.asarray(ref_img), jnp.asarray(sel), dyn.sigma_color,
        weak_radius=st.weak_radius), 2)
    tf_t = deformable.pack_tap_fields(_t(ref_img), weak.patch_candidates(
        _t(ref_img), _t(sel), dyn_t.sigma_color,
        weak_radius=st.weak_radius), 2)
    np.testing.assert_array_equal(np_(tf_t), np.asarray(tf_j))
    grids = tuple(jnp.asarray(np_(a)) for a in (xs, ys, rx, ry, parity))

    def j_half(state, anchors_j, fit_j, key, tf):
        return j_pm._propagate_color_weak(
            state, anchors_j, fit_j, 0, 0, key, ctx_j, None, ctx_yzl_j, None,
            None, jnp.asarray(ref_img), ref, src_cams, st, dyn, *grids,
            tap_fields=tf)

    j_in = (JState(**{f: jnp.asarray(np_(getattr(state_t, f)))
                      for f in ("plane", "cost", "sel_views",
                                "view_weights", "weak", "radius")}),
            JAnchorResult(*(jnp.asarray(np_(a)) for a in anchors)),
            jnp.asarray(np_(fit)), draws.derive(path_it), tf_j)
    want = compile_jax(j_half, *j_in)(*j_in)
    _build.reset_launches()
    got = t_pm._propagate_color_weak(
        state_t, anchors, fit, 0, 0, path_it, draws, ctx_t, None, ctx_yzl_t,
        None, None, _t(ref_img), ref_t, src_t, static_t, dyn_t, xs, ys, rx,
        ry, parity, tap_fields=tf_t)
    assert _build.LAUNCHES["anchor"] == 0
    wk = (weak_np == PixelState.WEAK) & (np_(parity) == 0)
    moved = (np.asarray(want.plane) != plane).any(-1)
    plane_ok = (np.abs(np_(got.plane) - np.asarray(want.plane))
                <= 1e-4).all(-1)
    cost_ok = np.abs(np_(got.cost) - np.asarray(want.cost)) <= 1e-4
    print(f"weak half with taps: {int(wk.sum())} weak px of color 0, "
          f"{int((moved & wk).sum())} moved; planes within 1e-4 at "
          f"{plane_ok[wk].mean():.4f}, costs at {cost_ok[wk].mean():.4f}")
    assert int((moved & wk).sum()) > 10
    assert plane_ok[wk].mean() >= 0.99
    assert plane_ok.mean() >= 0.99


def weak_find(weak_np, plane_np, ref_t, draws, st, dyn_t):
    """The port's anchor search on the given state (both packages get its
    anchors)."""
    return weak.find_anchors(
        _t(weak_np), _t(plane_np), ref_t, draws, split((), 3, 1),
        rotate_time=st.rotate_time,
        depth_range=float(np.float32(dyn_t.depth_max)
                          - np.float32(dyn_t.depth_min)),
        ransac_threshold=dyn_t.ransac_threshold)
