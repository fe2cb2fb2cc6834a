"""The port's kernels (K1 NCC, K2 sweep, K3 geom) against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions against the JAX functions (the exact XLA
paths, and the Pallas kernels in interpret mode) on the same inputs.  The
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import np_, t_camera, t_cameras

from dvpmvs.geometry import stack_cameras
from dvpmvs.geometry.transforms import dist_to_origin
from dvpmvs.kernels.geom import build_geom_context as j_build_geom
from dvpmvs.kernels.geom import geom_consistency_cost as j_geom_cost
from dvpmvs.kernels.geom_pallas import geom_cost_pallas
from dvpmvs.kernels import ncc as j_ncc
from dvpmvs.kernels.ncc import build_cost_context as j_build_ctx
from dvpmvs.kernels.ncc import ncc_cost as j_ncc_cost
from dvpmvs.kernels.ncc_fused import fused_cost_from_ctx as j_fused
from dvpmvs.kernels.sweep import _mean_selected_baseline as j_baseline
from dvpmvs.kernels.sweep import _sweep_costs as j_sweep_costs
from dvpmvs.kernels.sweep import classify_from_sweep as j_classify
from dvpmvs.kernels.sweep_pallas import sweep_weighted_from_ctx as j_sweep
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch.engine.packing import pack_ctx, pack_parity
from dvpmvs_torch.kernels import _build, geom_fused, ncc_fused, sweep_fused
from dvpmvs_torch.kernels import ncc as t_ncc
from dvpmvs_torch.kernels.geom import build_geom_context
from dvpmvs_torch.kernels.ncc import build_cost_context
from dvpmvs_torch.kernels.sweep import (_mean_selected_baseline,
                                        classify_from_sweep)

H, W, V = 48, 160, 2          # the shape of tests/test_pallas.py
K, K0 = 9, 4


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=4)
    ref = scene.cameras[0]
    src = stack_cameras(scene.cameras[1:])
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    n = jnp.asarray(scene.gt_normal[0])
    d = jnp.asarray(scene.gt_depth[0])
    plane = jnp.concatenate([n, dist_to_origin(n, xs, ys, d, ref)[..., None]],
                            -1)
    planes = jnp.stack([plane, plane.at[..., 3].mul(1.1),
                        plane.at[..., 3].mul(1.4)])
    rmap = np.random.default_rng(0).uniform(3.0, 7.0, (H, W)).astype(
        np.float32)
    return dict(scene=scene, ref=ref, src=src, planes=planes, rmap=rmap,
                t_ref=t_camera(ref), t_src=t_cameras(scene.cameras[1:]))


def _ctxs(s, backend_j, radius_map=None, color_only=False):
    img = s["scene"].images
    j = j_build_ctx(jnp.asarray(img[0]), jnp.asarray(img[1:]), s["ref"],
                    s["src"], 5.0, 3.0, backend=backend_j,
                    radius_map=None if radius_map is None
                    else jnp.asarray(radius_map),
                    color_only_weights=color_only)
    t = build_cost_context(torch.as_tensor(img[0]), torch.as_tensor(img[1:]),
                           s["t_ref"], s["t_src"], 5.0, 3.0, backend="fused",
                           radius_map=None if radius_map is None
                           else torch.as_tensor(radius_map),
                           color_only_weights=color_only)
    return j, t


_CTX_FIELDS = ("M", "b", "w_taps", "wref_taps", "sum_w", "sum_wref",
               "sum_wref2", "radius", "rx", "ry")


def _same_inputs(ctx_t, ctx_j):
    """The port context carrying the JAX context's fields (same inputs)."""
    return ctx_t.replace(**{f: torch.as_tensor(np.array(getattr(ctx_j, f)))
                            for f in _CTX_FIELDS})


@pytest.mark.parametrize("variant", ["static", "radius_map", "color_only"])
def test_ncc_plain_matches_jax_exact(setup, variant):
    """K1's plain version vs _ncc_cost_exact on the same inputs: |d| <= 1e-4
    except where float differences flip the variance gate or the in-view
    test (cost jumps to 2); such entries are at most 1e-4 of all.  From the
    port's own context (its exp and einsum round differently) the costs
    stay within 1e-3, median <= 3e-5 (measured: max 9.1e-4, median
    1.3e-5): the NCC variance m2 - m^2 at intensities ~128 amplifies
    last-bit input differences."""
    rmap = setup["rmap"] if variant == "radius_map" else None
    ctx_j, ctx_t = _ctxs(setup, "exact", radius_map=rmap,
                         color_only=variant == "color_only")
    want = np.stack([np.asarray(j_ncc_cost(ctx_j, p))
                     for p in setup["planes"]])
    planes = torch.as_tensor(np.array(setup["planes"]))
    got = np_(ncc_fused.fused_cost_from_ctx(_same_inputs(ctx_t, ctx_j),
                                            planes))
    assert got.shape == want.shape == (3, H, W, V)
    diff = np.abs(got - want)
    share = float((diff > 1e-4).mean())
    own = np.abs(np_(ncc_fused.fused_cost_from_ctx(ctx_t, planes)) - want)
    print(f"K1 plain vs exact ({variant}): same inputs max {diff.max():.3e} "
          f"share>1e-4 {share:.2e}; own context max {own.max():.3e} "
          f"median {np.median(own):.3e}")
    assert share <= 1e-4, share
    assert float((own > 1e-3).mean()) <= 1e-4
    assert np.median(own) <= 3e-5


def test_sampling_helpers_match_jax():
    """tap_grid, bilinear_sample (border clamp, NaN coordinates) and shift2
    on the same inputs: equal to float32 rounding."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0.0, 255.0, (H, W)).astype(np.float32)
    x = rng.uniform(-3.0, W + 3.0, (7, 11)).astype(np.float32)
    y = rng.uniform(-3.0, H + 3.0, (7, 11)).astype(np.float32)
    x[0, 0] = np.nan
    np.testing.assert_array_equal(t_ncc.tap_grid(), np.asarray(
        j_ncc.tap_grid()))
    want = np.asarray(j_ncc.bilinear_sample(jnp.asarray(img), x, y))
    got = np_(t_ncc.bilinear_sample(torch.as_tensor(img), torch.as_tensor(x),
                                    torch.as_tensor(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert np.isnan(got[0, 0]) == np.isnan(want[0, 0])
    for dx, dy in ((3, -2), (-5, 4)):
        np.testing.assert_array_equal(
            np_(t_ncc.shift2(torch.as_tensor(img), dx, dy)),
            np.asarray(j_ncc.shift2(jnp.asarray(img), dx, dy)))


@pytest.mark.parametrize("radius_map", [False, True])
def test_cost_context_matches_jax(setup, radius_map):
    """build_cost_context's fields vs the JAX context: tap weights and
    homography constants to float32 rounding (exp and einsum round
    differently), the moment sums to relative 1e-6."""
    ctx_j, ctx_t = _ctxs(setup, "exact",
                         radius_map=setup["rmap"] if radius_map else None)
    for f in _CTX_FIELDS:
        want = np.asarray(getattr(ctx_j, f))
        got = np_(getattr(ctx_t, f))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=f)


def test_ncc_plain_matches_jax_pallas_interpret(setup):
    """K1's plain version vs the Pallas kernel in interpret mode, with the
    bounds of tests/test_pallas.py (the Pallas kernel samples u8 quads)."""
    ctx_j, ctx_t = _ctxs(setup, "pallas")
    want = np.asarray(j_fused(ctx_j, setup["planes"], interpret=True))
    got = np_(ncc_fused.fused_cost_from_ctx(
        ctx_t, torch.as_tensor(np.array(setup["planes"]))))
    diff = np.abs(got - want)
    print(f"K1 plain vs Pallas interpret: median {np.median(diff):.3e} "
          f"max {diff.max():.3e}")
    assert np.median(diff) < 0.01
    assert (diff > 0.3).sum() == 0, diff.max()


@pytest.mark.parametrize("color", [0, 1])
def test_ncc_parity_packed_equals_unpacked_then_packed(setup, color):
    _, ctx_t = _ctxs(setup, "exact", radius_map=setup["rmap"])
    planes = torch.as_tensor(np.array(setup["planes"]))
    dense = ncc_fused.fused_cost_from_ctx(ctx_t, planes)
    packed = ncc_fused.fused_cost_from_ctx(
        pack_ctx(ctx_t, color), pack_parity(planes, color, axis=1),
        parity=color)
    assert torch.equal(packed, pack_parity(dense, color, axis=1))


def _sweep_inputs(setup):
    scene, ref = setup["scene"], setup["ref"]
    depth = scene.gt_depth[0]
    bl = float(np.linalg.norm(np.asarray(ref.c)
                              - np.asarray(setup["src"].c[0])))
    vw = np.random.default_rng(0).uniform(0.0, 1.0, (H, W, V)).astype(
        np.float32)
    return depth, np.full((H, W), bl, np.float32), vw


def test_sweep_plain_matches_jax_pallas_interpret(setup):
    """K2's plain version vs the Pallas sweep kernel in interpret mode,
    masking the 6-px border (the border semantics differ, and the Pallas
    kernel samples u8 quads).  tests/test_sweep_pallas.py allows a median
    of 0.02 and a share of 0.06 above 0.5; measured here: median 1.8e-3,
    share 0.020."""
    depth, baseline, vw = _sweep_inputs(setup)
    fx = float(setup["ref"].fx)
    ctx_j, ctx_t = _ctxs(setup, "pallas")
    want = np.asarray(j_sweep(ctx_j, jnp.asarray(depth),
                              jnp.asarray(baseline), fx, jnp.asarray(vw),
                              K=K, k0=K0, interpret=True))
    got = np_(sweep_fused.sweep_weighted_from_ctx(
        ctx_t, torch.as_tensor(depth), torch.as_tensor(baseline),
        setup["t_ref"].fx, torch.as_tensor(vw), K=K, k0=K0))
    m = np.zeros((H, W), bool)
    m[6:-6, 6:-6] = True
    diff = np.abs(got - want)[:, m]
    share = float((diff > 0.5).mean())
    print(f"K2 plain vs Pallas interpret: median {np.median(diff):.3e} "
          f"share>0.5 {share:.3e}")
    assert np.median(diff) < 0.005
    assert share < 0.03


def test_sweep_classification_agrees_with_exact(setup):
    """DepthToWeak classification from the field sweep (K2 plain) vs the
    JAX exact constant-plane sweep: agreement > 0.85 (the bound of
    tests/test_sweep_pallas.py)."""
    scene, ref, src = setup["scene"], setup["ref"], setup["src"]
    depth = scene.gt_depth[0]
    normal = scene.gt_normal[0]
    sel = np.ones((H, W, V), bool)
    vw = np.ones((H, W, V), np.float32)
    rsteps = K0
    ctx_j, ctx_t = _ctxs(setup, "exact")
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    baseline_j, nsel_j = j_baseline(jnp.asarray(sel), ref, src)
    fx = float(ref.fx)
    disp = fx * baseline_j / jnp.asarray(depth)
    ks = jnp.arange(-rsteps, rsteps + 1, dtype=jnp.float32)
    dstack = fx * baseline_j / (disp[None] + ks[:, None, None])
    p_exact = j_sweep_costs(ctx_j, None, 0.2, jnp.asarray(normal), dstack,
                            jnp.asarray(sel), jnp.asarray(vw), xs, ys, ref,
                            0.1, 100.0)
    cls_e = np.asarray(j_classify(jnp.minimum(2.0, p_exact),
                                  jnp.asarray(depth), nsel_j, rsteps, 2.0))

    t_sel = torch.as_tensor(sel)
    baseline_t, nsel_t = _mean_selected_baseline(t_sel, setup["t_ref"],
                                                 setup["t_src"])
    t_depth = torch.as_tensor(depth)
    p_field = sweep_fused.sweep_weighted_from_ctx(
        ctx_t, t_depth, baseline_t, setup["t_ref"].fx, torch.as_tensor(vw),
        K=2 * rsteps + 1, k0=rsteps) / float(V)
    fx_t = setup["t_ref"].fx
    dstack_t = fx_t * baseline_t / (
        fx_t * baseline_t / t_depth
        + torch.arange(-rsteps, rsteps + 1, dtype=torch.float32)[:, None,
                                                                 None])
    in_range = (dstack_t >= 0.1) & (dstack_t <= 100.0)
    p_field = torch.where(in_range, p_field, torch.full_like(p_field, 2.0))
    cls_f = np_(classify_from_sweep(torch.clamp(p_field, max=2.0), t_depth,
                                    nsel_t, rsteps, 2.0))
    agree = float((cls_e == cls_f)[6:-6, 6:-6].mean())
    print(f"K2 classification agreement vs exact: {agree:.4f}")
    assert agree > 0.85, agree


def _geom_inputs(setup):
    scene = setup["scene"]
    depth = scene.gt_depth[0]
    ks = np.linspace(0.9, 1.1, 5, dtype=np.float32)
    dstack = (depth[None] * ks[:, None, None]).astype(np.float32)
    src_depths = scene.gt_depth[1:]
    return dstack, src_depths


def test_geom_plain_matches_jax_dense(setup):
    """K3's plain per-view mode vs geom_consistency_cost: |d| <= 1e-4
    except rounding flips of the nearest source-depth lookup, at most
    1e-3 of the entries."""
    dstack, src_depths = _geom_inputs(setup)
    g_j = j_build_geom(jnp.asarray(src_depths), setup["ref"], setup["src"])
    want = np.stack([np.asarray(j_geom_cost(g_j, jnp.asarray(d)))
                     for d in dstack])
    g_t = build_geom_context(torch.as_tensor(src_depths), setup["t_ref"],
                             setup["t_src"])
    got = np_(geom_fused.geom_cost(g_t, torch.as_tensor(dstack)))
    assert got.shape == want.shape == (5, H, W, V)
    diff = np.abs(got - want)
    share = float((diff > 1e-4).mean())
    print(f"K3 plain vs XLA: max {diff.max():.3e} share>1e-4 {share:.2e}")
    assert share <= 1e-3, share


def test_geom_plain_fold_matches_jax_pallas_interpret(setup):
    """K3's plain fold mode vs the Pallas geom kernel (fold) in interpret
    mode: |d| <= 1e-3 except lookup rounding flips (<= 1e-3 of entries)."""
    dstack, src_depths = _geom_inputs(setup)
    _, _, vw = _sweep_inputs(setup)
    g_j = j_build_geom(jnp.asarray(src_depths), setup["ref"], setup["src"])
    want = np.asarray(geom_cost_pallas(g_j, jnp.asarray(dstack),
                                       vweights=jnp.asarray(vw), fold=True,
                                       interpret=True))
    g_t = build_geom_context(torch.as_tensor(src_depths), setup["t_ref"],
                             setup["t_src"])
    got = np_(geom_fused.geom_cost(g_t, torch.as_tensor(dstack),
                                   vweights=torch.as_tensor(vw), fold=True))
    diff = np.abs(got - want)
    share = float((diff > 1e-3).mean())
    print(f"K3 fold plain vs Pallas interpret: max {diff.max():.3e} "
          f"share>1e-3 {share:.2e}")
    assert share <= 1e-3, share


def test_wrappers_run_plain_on_cpu_and_count_no_launch(setup):
    """A CPU tensor takes the plain version; no launch is counted."""
    _build.reset_launches()
    _, ctx_t = _ctxs(setup, "exact")
    ncc_fused.fused_cost_from_ctx(
        ctx_t, torch.as_tensor(np.array(setup["planes"][:1])))
    assert _build.LAUNCHES == {"ncc_fused": 0, "sweep": 0, "geom": 0}
