"""K4 (the slot-exact anchor terms) and K3's checkerboard-parity mode
against the JAX package, on the CPU, where each wrapper runs its kernel's
plain version: the anchor fields at compacted pixels, K4's plain version
against JAX's fp32 oracle (``anchor_cost_term_for_plane`` on an exact-backend
context) and against the Pallas kernel in interpret mode (which reads u8
quads), and K3 parity against ``geom_cost_pallas(parity=...)`` in interpret
mode.  The setup is that of tests/test_anchor_pallas.py: 48x64, V=3, A=11,
S=10, K=700, plus a K that is a multiple of nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_anchor_pallas import _setup
from test_torch_support import np_, t_camera, t_cameras

from dvpmvs.engine.packing import pack_parity as j_pack_parity
from dvpmvs.geometry import stack_cameras
from dvpmvs.kernels.anchor_pallas import anchor_slot_costs_from_ctx as j_k4
from dvpmvs.kernels.deformable import anchor_cost_term_for_plane as j_term
from dvpmvs.kernels.deformable import anchor_fields_at as j_fields_at
from dvpmvs.kernels.geom import build_geom_context as j_build_geom
from dvpmvs.kernels.geom_pallas import geom_cost_pallas
from dvpmvs.kernels.ncc import build_cost_context as j_build_ctx
from dvpmvs.kernels.weak import AnchorResult as JAnchorResult
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch import convert
from dvpmvs_torch.engine.packing import pack_parity
from dvpmvs_torch.kernels import _build, anchor_fused, geom_fused
from dvpmvs_torch.kernels.deformable import (AnchorFields, anchor_fields_at,
                                             anchor_cost_term_for_plane)
from dvpmvs_torch.kernels.geom import build_geom_context
from dvpmvs_torch.kernels.ncc import build_cost_context


def _t(a):
    return torch.as_tensor(np.array(a))


def _t_fields(af) -> AnchorFields:
    return AnchorFields(*(_t(getattr(af, f)) for f in AnchorFields._fields))


def _t_ctx(ctx_j):
    """A port context carrying the JAX context's sources and homography
    terms (all the anchor term reads)."""
    t_ctx = build_cost_context(
        _t(ctx_j.src_imgs[0]), _t(ctx_j.src_imgs), *_cams(), 5.0, 3.0)
    return t_ctx.replace(src_imgs=_t(ctx_j.src_imgs), M=_t(ctx_j.M),
                         b=_t(ctx_j.b), src_wh=_t(ctx_j.src_wh))


def _k4_plain(ctx_j, planes, af):
    """K4 through the port's wrapper (its plain version on the CPU)."""
    _build.reset_launches()
    out = anchor_fused.anchor_slot_costs_from_ctx(_t_ctx(ctx_j), _t(planes),
                                                  _t_fields(af))
    assert _build.LAUNCHES["anchor"] == 0
    return out


def _cams(seed=0, V=3):
    scene = make_scene(num_views=V + 1, height=48, width=64, seed=seed)
    return t_camera(scene.cameras[0]), t_cameras(scene.cameras[1:V + 1])


def test_anchor_fields_at_matches_jax():
    """Every field equal (floats within 1e-6), on one checkerboard color
    with anchors clipped at the border and unselected views."""
    H, W, V, A, color = 32, 48, 3, 11, 1
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=1)
    rng = np.random.default_rng(4)
    coords = rng.integers(-3, max(H, W) + 3, (A, H, W, 2)).astype(np.int32)
    valid = rng.uniform(size=(A, H, W)) < 0.7
    reliable = rng.uniform(size=(H, W)) < 0.8
    sel = rng.uniform(size=(H, W, V)) < 0.6
    Wp = (W + 1) // 2
    gidx = rng.choice(H * Wp, 200, replace=False).astype(np.int32)
    ri = np.asarray(scene.images[0])
    ctx_j = j_build_ctx(jnp.asarray(ri), jnp.asarray(scene.images[1:]),
                        scene.cameras[0], stack_cameras(scene.cameras[1:]),
                        5.0, 3.0, color_only_weights=True)
    want = j_fields_at(ctx_j, JAnchorResult(jnp.asarray(coords),
                                            jnp.asarray(valid),
                                            jnp.asarray(reliable)),
                       jnp.asarray(sel), jnp.asarray(ri), jnp.float32(3.0),
                       lambda a: j_pack_parity(a, color), jnp.asarray(gidx))
    ctx_t = build_cost_context(_t(ri), _t(scene.images[1:]),
                               t_camera(scene.cameras[0]),
                               t_cameras(scene.cameras[1:]), 5.0, 3.0,
                               color_only_weights=True)
    anchors = convert.anchors(dict(coords=coords, valid=valid,
                                   reliable=reliable), device="cpu")
    got = anchor_fields_at(ctx_t, anchors, _t(sel), _t(ri), 3.0,
                           lambda a, axis=0: pack_parity(a, color, axis),
                           _t(gidx))
    for f in AnchorFields._fields:
        g, w = np_(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("K", [700, 333])
def test_k4_plain_matches_jax_fp32_oracle(K):
    """K4's plain version vs JAX's anchor_cost_term_for_plane over the
    slots on an exact-backend context (fp32 bilinear sources), run op by
    op: has equal; cost within 1e-4 except at <= 1e-3 of the entries,
    where a warped coordinate lands on the other side of a floor() or an
    in-view boundary.  Measured: max |d| 1.2e-7.  (A compiled JAX oracle
    contracts multiply-adds: 0.4 % of the entries then move by more than
    1e-4, the small anchor groups amplifying last-bit differences.)"""
    ctx_j, af, planes = _setup(K=K, seed=0 if K == 700 else 3)
    ctx_x = j_build_ctx(ctx_j.src_imgs[0], ctx_j.src_imgs, *_jcams(),
                        5.0, 3.0, backend="exact", color_only_weights=True)
    ctx_x = ctx_x.replace(M=ctx_j.M, b=ctx_j.b, src_wh=ctx_j.src_wh)
    assert ctx_x.packed_quads is None
    with jax.disable_jit():
        terms = [j_term(ctx_x, p, af) for p in planes]
    want = jax.tree.map(lambda *x: np.stack(x), *terms)
    got = _k4_plain(ctx_j, planes, af)
    assert tuple(got.cost.shape) == (10, K, 3)
    # the per-slot form of the same function (the port's
    # anchor_cost_term_for_plane) gives the same numbers
    one = anchor_cost_term_for_plane(_t_ctx(ctx_j), _t(planes[3]),
                                     _t_fields(af))
    assert torch.equal(one.cost, got.cost[3])
    assert torch.equal(one.has_anchors, got.has_anchors[3])
    np.testing.assert_array_equal(np_(got.has_anchors),
                                  np.asarray(want.has_anchors))
    diff = np.abs(np_(got.cost) - np.asarray(want.cost))
    share = float((diff > 1e-4).mean())
    print(f"K4 plain vs JAX fp32 oracle (K={K}): max {diff.max():.3e} "
          f"share>1e-4 {share:.2e}")
    assert share <= 1e-3, share
    # the term is not degenerate: most entries are real group costs
    assert float((np_(got.cost) < 2.0).mean()) > 0.5


def _jcams(seed=0, V=3):
    scene = make_scene(num_views=V + 1, height=48, width=64, seed=seed)
    return scene.cameras[0], stack_cameras(scene.cameras[1:V + 1])


def test_k4_plain_matches_jax_pallas_interpret():
    """K4's plain version (fp32 sources) vs the Pallas kernel in interpret
    mode, which samples u8 packed quads (sources rounded to integers): has
    equal; the costs agree by distribution.  Measured: median |d| 4.2e-4,
    96.8 % of the entries within 0.01, mean |d| 2.1e-3."""
    ctx_j, af, planes = _setup(seed=0)
    want = j_k4(ctx_j, planes, af, interpret=True)
    got = _k4_plain(ctx_j, planes, af)
    np.testing.assert_array_equal(np_(got.has_anchors),
                                  np.asarray(want.has_anchors))
    diff = np.abs(np_(got.cost) - np.asarray(want.cost))
    med = float(np.median(diff))
    within = float((diff <= 0.01).mean())
    print(f"K4 plain vs Pallas interpret: median {med:.3e} "
          f"share<=0.01 {within:.3f} mean {diff.mean():.3e}")
    assert med <= 2e-3, med
    assert within >= 0.9, within
    assert diff.mean() <= 0.01, diff.mean()


@pytest.mark.parametrize("W", [256, 255])
@pytest.mark.parametrize("color", [0, 1])
def test_geom_parity_plain_matches_jax_pallas_interpret(W, color):
    """K3's plain parity mode vs geom_cost_pallas(parity=c) in interpret
    mode, even and odd widths: share of |d| > 1e-3 at most 1e-3 (nearest
    source-depth lookups that round the other way).  Measured: no entry
    above 1e-3.

    The packed width is one full 128-lane tile of the Pallas kernel: its
    padding lanes (inverse depth 0) join the minimum row of its 8-row
    gather band and clamp the real rows of their tile (at 48x64, packed
    32 of 128 lanes, 25 % of the entries move by up to 0.075).  That tail
    belongs to the TPU kernel; the port's kernel has no gather band."""
    H, V, K = 24, 3, 4
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=4)
    rng = np.random.default_rng(color)
    gt = np.asarray(scene.gt_depth[0])
    dstack = np.stack([np.asarray(j_pack_parity(jnp.asarray(gt), color))
                       * np.float32(1.0 + 0.02 * k) for k in range(K)])
    dstack = dstack * (1.0 + 0.01 * rng.standard_normal(dstack.shape))
    dstack = dstack.astype(np.float32)
    src_depths = np.asarray(scene.gt_depth[1:])
    g_j = j_build_geom(jnp.asarray(src_depths), scene.cameras[0],
                       stack_cameras(scene.cameras[1:]))
    want = np.asarray(geom_cost_pallas(g_j, jnp.asarray(dstack),
                                       parity=color, interpret=True))
    g_t = build_geom_context(_t(src_depths), t_camera(scene.cameras[0]),
                             t_cameras(scene.cameras[1:]))
    got = np_(geom_fused.geom_cost(g_t, _t(dstack), parity=color))
    assert got.shape == want.shape == (K, H, (W + 1) // 2, V)
    diff = np.abs(got - want)
    share = float((diff > 1e-3).mean())
    print(f"K3 parity {color} W={W}: max {diff.max():.3e} "
          f"share>1e-3 {share:.2e}")
    assert share <= 1e-3, share
    assert float((got < 3.0).mean()) > 0.5


def _k4_fixed_problem(n_extra, K=90, A=7, S=6, V=3, H=24, W=40):
    """K4's arguments through ``kernel_args`` at random anchors (A not a
    multiple of 4): the last 20 compacted entries are fill (ok_k false),
    view 1 is seen by no anchor of pixels 0-9, some anchors are invalid;
    the slot planes near the ground truth, with w = 0 (huge q), NaN and
    infinite planes at some pixels; random tap words with ``n_extra``."""
    from dvpmvs_torch.geometry import stack_cameras as t_stack
    from dvpmvs_torch.kernels.ncc import _grid
    from dvpmvs_torch.kernels.sampling import plane_from_normal_depth
    from dvpmvs_torch.utils.synthetic import make_scene as t_scene
    sc = t_scene(num_views=V + 1, height=H, width=W, seed=4)
    ref, src = sc.cameras[0], t_stack(sc.cameras[1:])
    img = torch.as_tensor(sc.images)
    ctx = build_cost_context(img[0], img[1:], ref, src, 5.0, 3.0,
                             backend="fused", color_only_weights=True)
    rng = np.random.default_rng(K + n_extra)
    ax = torch.as_tensor(rng.integers(0, W, (A, K)), dtype=torch.int32)
    ay = torch.as_tensor(rng.integers(0, H, (A, K)), dtype=torch.int32)
    ref_a = img[0].reshape(-1)[(ay * W + ax).long()]
    sees = torch.as_tensor(rng.uniform(size=(V, A, K)) < 0.85)
    sees[1, :, :10] = False
    af = AnchorFields(
        ax=ax, ay=ay, rax=(ax.float() - ref.cx) / ref.fx,
        ray=(ay.float() - ref.cy) / ref.fy,
        valid=torch.as_tensor(rng.uniform(size=(A, K)) < 0.9), ref_a=ref_a,
        w_col=torch.exp(-torch.abs(ref_a - torch.as_tensor(
            rng.uniform(0, 255, (A, K)), dtype=torch.float32)) / 18.0),
        sees=sees)
    ok_k = torch.arange(K) < K - 20
    xs, ys = _grid(H, W, "cpu")
    plane = plane_from_normal_depth(torch.as_tensor(sc.gt_normal[0]),
                                    torch.as_tensor(sc.gt_depth[0]), xs, ys,
                                    ref).reshape(-1, 4)
    planes = plane[torch.as_tensor(rng.integers(0, H * W, (S, K)))]
    planes[..., 3] *= torch.as_tensor(1.0 + 0.1 * (rng.uniform(
        size=(S, K)) - 0.5), dtype=torch.float32)
    planes[0, ::3, 3] = 0.0
    planes[1, ::4] = float("nan")
    planes[2, ::5, 0] = float("inf")
    words = None
    if n_extra:
        words = torch.as_tensor(rng.integers(0, 2 ** 24, (V, n_extra, A, K)),
                                dtype=torch.int32)
    return anchor_fused.kernel_args(ctx, planes, af, ok_k, words), ok_k


@pytest.mark.parametrize("n_extra", [0, 2])
def test_k4_plain_fixed_result_without_a_usable_anchor(n_extra):
    """csrc/anchor.cu writes cost 0.0 and has false for a (k, v) whose
    anchors all have bit v clear, without warping.  The plain version gives
    exactly that, whatever the samples: at fill entries, at real pixels
    whose anchors do not see the view, and under non-finite slot planes
    (which give NaN samples elsewhere)."""
    args, ok_k = _k4_fixed_problem(n_extra)
    vbits, S = args[9], args[4].shape[0]
    V = args[0].shape[0]
    fixed = torch.stack([((vbits >> v) & 1).sum(0) == 0 for v in range(V)],
                        -1)                                     # [K, V]
    assert bool(fixed[~ok_k].all()) and bool(fixed[:10, 1].all())
    assert not bool(fixed[ok_k].all())
    out = anchor_fused.anchor_slot_costs(*args)
    fx = fixed[None].expand(S, -1, -1)
    assert bool((out.cost[fx] == 0.0).all())
    assert not bool(out.has_anchors[fx].any())
    # elsewhere the term has work, and the degenerate planes reach it
    assert bool(out.has_anchors[~fx].any())
    assert bool((out.cost[~fx] > 0.0).any())
    assert not bool(torch.isfinite(args[4]).all())
