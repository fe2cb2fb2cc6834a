"""The reference-exact deformable oracle (``PMStatic.exact_deformable``)
against the JAX package on the CPU, on the inputs of JAX's
``tests/test_deformable_exact.py::weak_band`` fixture, rebuilt here: a
textureless band at 40x56 with V = 2 source views, its planes 25 % too far,
A = 11 anchors.  The anchors and the fit plane come from the port's search
with JAX's draws (JAX's op-by-op search takes ~45 s; the two searches agree,
tests/test_torch_anchor.py), and both packages get the same numbers.

* ``deformable_cost_exact`` against JAX's run op by op
  (``jax.disable_jit``): a ``jax.jit`` of the oracle reorders its sums and
  moves the band's near-zero variances (measured: the jitted JAX agrees
  with the op-by-op JAX within 1e-5 at 0.49 of the entries under XLA's
  default pipeline, 0.88 under ``JAX_FAST_COMPILE``);
* one exact weak half-iteration against JAX's ``_propagate_color_weak``
  compiled with ``JAX_FAST_COMPILE``, with JAX's draws (one color: JAX's
  compile of the oracle is the cost, ~17 s);
* the port's exact mode against its fused production mode on the band's
  acc2, with the assertions of JAX's ``test_warpfield_vs_exact_accuracy``;
* a whole exact APD pass through ``run_pass``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (JaxDraws, compile_jax, jax_math, np_,
                                t_camera, t_cameras)

from dvpmvs.config import PMDynamic, PMStatic, PixelState, RunState
from dvpmvs.engine import patchmatch as j_pm
from dvpmvs.engine.patchmatch import _grids, _initial_cost_refine
from dvpmvs.engine.state import PMState as JState
from dvpmvs.geometry import stack_cameras as j_stack_cameras
from dvpmvs.geometry.transforms import plane_from_world
from dvpmvs.kernels import deformable as j_def
from dvpmvs.kernels.ncc import build_cost_context as j_build_ctx
from dvpmvs.kernels.weak import AnchorResult as JAnchorResult
from dvpmvs.kernels.weak import patch_candidates as j_patch_candidates
from dvpmvs.utils.synthetic import make_scene as j_make_scene

from dvpmvs_torch import config as t_config, convert
from dvpmvs_torch.engine import patchmatch as t_pm
from dvpmvs_torch.engine.packing import pack_ctx
from dvpmvs_torch.engine.state import PMState as TState
from dvpmvs_torch.geometry import stack_cameras
from dvpmvs_torch.geometry.transforms import depth_from_plane
from dvpmvs_torch.kernels import deformable as t_def, weak as t_weak
from dvpmvs_torch.kernels.ncc import build_cost_context
from dvpmvs_torch.rng import TorchDraws
from dvpmvs_torch.utils.synthetic import make_scene

_CTX_FIELDS = ("M", "b", "w_taps", "wref_taps", "sum_w", "sum_wref",
               "sum_wref2", "radius", "rx", "ry", "src_wh")


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def weak_band():
    """JAX's fixture's inputs: the band scene, its weak map, the corrupted
    plane field, the contexts and initial selection (JAX), the anchors and
    the fit plane (the port, with JAX's draws)."""
    H, W = 40, 56
    scene = j_make_scene(num_views=3, height=H, width=W, seed=11)
    imgs = np.asarray(scene.images).copy()
    band = slice(16, 26)
    imgs[:, band, :] = imgs[:, band, :].mean(axis=(1, 2), keepdims=True)
    weak = np.full((H, W), 1, np.int8)
    weak[band, 6:-6] = 0
    ref_cam = scene.cameras[0]
    src_cams = j_stack_cameras(scene.cameras[1:3])
    gtd = jnp.asarray(scene.gt_depth[0])
    d0 = jnp.where(jnp.asarray(weak == 0), gtd * 1.25, gtd)
    init_pw = jnp.concatenate([jnp.asarray(scene.gt_normal[0]),
                               d0[..., None]], -1)
    xs, ys = _grids(H, W)
    plane = plane_from_world(init_pw, xs, ys, ref_cam)
    dyn = PMDynamic.create(depth_min=float(ref_cam.depth_min),
                           depth_max=float(ref_cam.depth_max))
    ri, si = jnp.asarray(imgs[0]), jnp.asarray(imgs[1:3])
    ctx, ctx_yzl = (j_build_ctx(ri, si, ref_cam, src_cams, 5.0, 3.0,
                                backend="exact", color_only_weights=only)
                    for only in (False, True))
    cost, sel = _initial_cost_refine(ctx, plane, jnp.ones((H, W, 2), bool))

    ref_t = t_camera(ref_cam)
    anchors_t = t_weak.find_anchors(
        _t(weak), _t(plane), ref_t, JaxDraws(jax.random.PRNGKey(1)), (),
        rotate_time=2, ransac_threshold=float(dyn.ransac_threshold),
        depth_range=float(np.float32(dyn.depth_max)
                          - np.float32(dyn.depth_min)), use_limit=True)
    weak2 = np.where((weak == 0) & ~np_(anchors_t.reliable),
                     int(PixelState.UNKNOWN), weak).astype(np.int8)
    fit_t, _ = t_weak.ransac_fit_plane(
        anchors_t, _t(plane), _t(weak2), ref_t,
        JaxDraws(jax.random.PRNGKey(3)), (), use_radius=False,
        strong_radius=5)
    return dict(scene=scene, imgs=imgs, weak=weak2, ref_cam=ref_cam,
                src_cams=src_cams, dyn=dyn, ri=ri, ctx=ctx, ctx_yzl=ctx_yzl,
                plane=plane, cost=cost, sel=sel, gtd=gtd,
                anchors=JAnchorResult(*(jnp.asarray(np_(a))
                                        for a in anchors_t)),
                fit_plane=jnp.asarray(np_(fit_t)))


def _port_inputs(wb):
    """The fixture's contexts (JAX's fields, so both packages start from the
    same numbers), anchors, state and patch candidates for the port."""
    scene = wb["scene"]
    ref_t, src_t = t_camera(wb["ref_cam"]), t_cameras(scene.cameras[1:3])
    ri, si = _t(wb["imgs"][0]), _t(wb["imgs"][1:3])

    def ctx(j, only):
        return build_cost_context(
            ri, si, ref_t, src_t, 5.0, 3.0, backend="exact",
            color_only_weights=only).replace(
                **{f: _t(getattr(j, f)) for f in _CTX_FIELDS})

    H, W = ri.shape
    xs, ys = _grids(H, W)
    rc = wb["ref_cam"]
    rx, ry = (xs - rc.cx) / rc.fx, (ys - rc.cy) / rc.fy
    parity = (xs.astype(jnp.int32) + ys.astype(jnp.int32)) % 2
    sel_t = _t(wb["sel"])
    return dict(
        ref=ref_t, src=src_t, ri=ri, ctx=ctx(wb["ctx"], False),
        ctx_yzl=ctx(wb["ctx_yzl"], True),
        anchors=convert.anchors(wb["anchors"], device="cpu"),
        patch_off=t_weak.patch_candidates(ri, sel_t, float(
            wb["dyn"].sigma_color), weak_radius=5),
        grids=tuple(_t(a) for a in (xs, ys, rx, ry, parity)),
        state=TState(plane=_t(wb["plane"]), cost=_t(wb["cost"]),
                     sel_views=sel_t, view_weights=torch.zeros((H, W, 2)),
                     weak=_t(wb["weak"]), radius=torch.zeros((H, W))),
        fit=_t(wb["fit_plane"]), parity=np.asarray(parity))


def _static(exact: bool) -> PMStatic:
    """JAX's test's static config of the weak pair."""
    return PMStatic(state=RunState.REFINE_ITER, num_src=2, max_iterations=1,
                    cost_backend="exact", use_APD=True, use_edge=False,
                    extend_rounds=0, use_label=False, use_radius=False,
                    exact_deformable=exact)


def test_deformable_cost_exact_matches_jax(weak_band):
    """The oracle's costs [H, W, V] of the fixture's (corrupted) plane field
    against JAX's op by op, with JAX's elementwise math: within 1e-5 at
    >= 99.9 % of the entries (measured: bitwise at every entry)."""
    wb = weak_band
    p = _port_inputs(wb)
    po = j_patch_candidates(wb["ri"], wb["sel"], wb["dyn"].sigma_color,
                            weak_radius=5)
    np.testing.assert_array_equal(np_(p["patch_off"]), np.asarray(po))
    with jax.disable_jit():
        want = np.asarray(j_def.deformable_cost_exact(
            wb["ctx_yzl"], wb["plane"], wb["anchors"], po, wb["sel"],
            wb["ri"], wb["dyn"].sigma_color))
    with jax_math():
        got = np_(t_def.deformable_cost_exact(
            p["ctx_yzl"], _t(wb["plane"]), p["anchors"], p["patch_off"],
            p["state"].sel_views, p["ri"], float(wb["dyn"].sigma_color)))
    assert got.shape == want.shape == wb["ri"].shape + (2,)
    close = np.abs(got - want) <= 1e-5
    print(f"exact oracle: within 1e-5 at {close.mean():.6f}, bitwise at "
          f"{(got == want).mean():.6f}")
    assert close.mean() >= 0.999


def test_exact_weak_half_iteration_matches_jax(weak_band):
    """One exact weak half-iteration (color 0) from the fixture's state,
    anchors and fit plane, with JAX's draws, against JAX's compiled with
    JAX_FAST_COMPILE.  The compiled oracle reorders the band's sums (see
    the module docstring), so the candidate choices at some band pixels
    differ: the bounds are 0.85 of the color's weak pixels and 0.98 of all
    pixels.  Measured: 200 weak pixels of color 0, all moved; planes within
    1e-4 at 0.905 of them, costs at 0.940, planes at 0.9915 of all
    pixels."""
    wb = weak_band
    p = _port_inputs(wb)
    rc = wb["ref_cam"]
    H, W = wb["ri"].shape
    xs, ys = _grids(H, W)
    rx, ry = (xs - rc.cx) / rc.fx, (ys - rc.cy) / rc.fy
    parity = (xs.astype(jnp.int32) + ys.astype(jnp.int32)) % 2
    static = _static(True)
    key = jax.random.PRNGKey(7)

    def j_half(state, anchors, fit, po):
        return j_pm._propagate_color_weak(
            state, anchors, fit, 0, 0, key, wb["ctx"], None, wb["ctx_yzl"],
            None, None, wb["ri"], rc, wb["src_cams"], static, wb["dyn"], xs,
            ys, rx, ry, parity, patch_off=po)

    j_in = (JState(plane=wb["plane"], cost=wb["cost"], sel_views=wb["sel"],
                   view_weights=jnp.zeros_like(wb["sel"], jnp.float32),
                   weak=jnp.asarray(wb["weak"]),
                   radius=jnp.zeros((H, W), jnp.float32)),
            wb["anchors"], wb["fit_plane"],
            jnp.asarray(np_(p["patch_off"])))
    want = compile_jax(j_half, *j_in)(*j_in)
    with jax_math():
        got = t_pm._propagate_color_weak(
            p["state"], p["anchors"], p["fit"], 0, 0, (), JaxDraws(key),
            p["ctx"], None, p["ctx_yzl"], None, None, p["ri"], p["ref"],
            p["src"], convert.static_params(static),
            convert.dynamic_params(wb["dyn"]), *p["grids"],
            patch_off=p["patch_off"])
    wk = (wb["weak"] == PixelState.WEAK) & (p["parity"] == 0)
    moved = (np.asarray(want.plane) != np.asarray(wb["plane"])).any(-1)
    plane_ok = (np.abs(np_(got.plane) - np.asarray(want.plane))
                <= 1e-4).all(-1)
    cost_ok = np.abs(np_(got.cost) - np.asarray(want.cost)) <= 1e-4
    print(f"exact weak half: {int(wk.sum())} weak px of color 0, "
          f"{int((moved & wk).sum())} moved; planes within 1e-4 at "
          f"{plane_ok[wk].mean():.4f} of them, costs at "
          f"{cost_ok[wk].mean():.4f}; planes at {plane_ok.mean():.4f} of "
          f"all pixels")
    assert int((moved & wk).sum()) > 100
    assert plane_ok[wk].mean() >= 0.85
    assert cost_ok[wk].mean() >= 0.85
    assert plane_ok.mean() >= 0.98


def _band_acc(wb, p, exact: bool) -> float:
    """The port's weak pair (both colors) on the fused backend from the
    fixture's state, with the port's own draws: the share of weak pixels
    whose depth lies within 2 % of the ground truth."""
    st = convert.static_params(_static(exact)).replace(cost_backend="fused")
    ctx = p["ctx"].replace(backend="fused")
    ctx_yzl = p["ctx_yzl"].replace(backend="fused")
    draws = TorchDraws(7, device="cpu")
    state = p["state"]
    for color in (0, 1):
        state = t_pm._propagate_color_weak(
            state, p["anchors"], p["fit"], color, 0, (), draws, ctx,
            pack_ctx(ctx, color), ctx_yzl, pack_ctx(ctx_yzl, color), None,
            p["ri"], p["ref"], p["src"], st,
            convert.dynamic_params(wb["dyn"]), *p["grids"],
            patch_off=p["patch_off"] if exact else None)
    xs, ys = p["grids"][:2]
    depth = np_(depth_from_plane(state.plane, xs, ys, p["ref"]))
    gt = np.asarray(wb["gtd"])
    m = wb["weak"] == PixelState.WEAK
    rel = np.abs(depth - gt) / np.maximum(gt, 1e-6)
    return float((rel[m] < 0.02).mean())


def test_exact_against_fused_mode_on_the_band(weak_band):
    """JAX's accuracy gate of the production anchor term against the
    oracle, on the port's fused backend (plain versions of K1 and K4 here):
    both pull the band toward the ground truth, and production stays within
    2 points of the oracle.  Measured: exact 0.723, fused 0.884 (JAX's
    recorded pair: 0.736 and 0.783)."""
    p = _port_inputs(weak_band)
    acc_exact = _band_acc(weak_band, p, exact=True)
    acc_fused = _band_acc(weak_band, p, exact=False)
    print(f"weak-band acc2 after one weak pair: exact {acc_exact:.3f}, "
          f"fused {acc_fused:.3f}")
    assert acc_exact > 0.5, acc_exact
    assert acc_fused > 0.5, acc_fused
    assert acc_fused > acc_exact - 0.02, (acc_fused, acc_exact)


def test_exact_pass_runs():
    """A whole REFINE_ITER APD pass with ``exact_deformable`` through
    ``run_pass`` on the fused backend: full-grid weak half-iterations, no
    compaction diagnostic, finite in-range depths."""
    H, W, V = 24, 32, 2
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=6,
                       weak_band=True)
    ref = scene.cameras[0]
    base = t_config.PMStatic(num_src=V, max_iterations=1, use_label=False,
                             cost_backend="fused", exact_deformable=True)
    st, dyn = t_config.round_pass_params(1, 2, 1, base,
                                         float(ref.depth_min),
                                         float(ref.depth_max))
    assert st.use_APD and st.cost_backend == "fused"
    gt = scene.gt_depth[0]
    plane_w = np.concatenate([scene.gt_normal[0], gt[..., None] * 1.1], -1)
    weak = np.full((H, W), int(PixelState.WEAK), np.int8)
    out = t_pm.run_pass(
        scene.images[0], scene.images[1:], ref,
        stack_cameras(scene.cameras[1:]),
        st, dyn, TorchDraws(0, device="cpu"),
        init_plane_world=plane_w.astype(np.float32),
        init_sel_views=np.ones((H, W, V), bool), init_weak=weak,
        src_depths=np.stack([scene.gt_depth[v] for v in range(1, V + 1)]),
        device="cpu")
    d = np_(out.depth)
    assert out.weak_overflow is None and out.cost_line is None
    assert np.isfinite(d).all() and (d > 0).mean() > 0.9
