"""K5 (the warp field) and the terms that read it, against the JAX package
on the CPU, where ``warp_fused.warp_field`` runs its plain version: the
warped field, the warp-once NCC of the "warp" cost backend, the dense anchor
fields, the candidate-independent anchor term and the deformable cost.

Setup: that of scripts/check_warpfield_pallas.py (48x160, V=3, the
ground-truth plane field of a seed-4 scene), plus a copy of that field with
w = 0 in a block of pixels (NaN coordinates there).  The JAX side runs op by
op (not jitted: XLA fuses and rounds otherwise), on exact-backend contexts;
the port's contexts carry the JAX contexts' fields, so that each test holds
one function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import np_, t_camera, t_cameras

from dvpmvs.engine.packing import pack_parity as j_pack_parity
from dvpmvs.geometry import stack_cameras
from dvpmvs.geometry.transforms import dist_to_origin
from dvpmvs.kernels import deformable as j_def
from dvpmvs.kernels import ncc as j_ncc
from dvpmvs.kernels.sweep_pallas import warp_field_pallas
from dvpmvs.kernels.weak import AnchorResult as JAnchorResult
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch import convert
from dvpmvs_torch.engine.packing import pack_parity
from dvpmvs_torch.kernels import _build, deformable, ncc

H, W, V, A = 48, 160, 3, 11
_CTX_FIELDS = ("M", "b", "w_taps", "wref_taps", "sum_w", "sum_wref",
               "sum_wref2", "radius", "rx", "ry", "src_wh")


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=4)
    ref = scene.cameras[0]
    src_cams = stack_cameras(scene.cameras[1:])
    ref_img, src_imgs = scene.images[0], scene.images[1:]
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    n = scene.gt_normal[0]
    w = np.asarray(dist_to_origin(jnp.asarray(n), jnp.asarray(xs),
                                  jnp.asarray(ys),
                                  jnp.asarray(scene.gt_depth[0]), ref))
    plane = np.concatenate([n, w[..., None]], -1).astype(np.float32)
    degenerate = plane.copy()
    degenerate[10:14, 30:90, 3] = 0.0
    rmap = np.random.default_rng(2).uniform(3.0, 7.0, (H, W)).astype(
        np.float32)

    def contexts(color_only=False, radius_map=None):
        cj = j_ncc.build_cost_context(
            jnp.asarray(ref_img), jnp.asarray(src_imgs), ref, src_cams, 5.0,
            3.0, backend="exact", color_only_weights=color_only,
            radius_map=None if radius_map is None else jnp.asarray(
                radius_map))
        ct = ncc.build_cost_context(
            _t(ref_img), _t(src_imgs), t_camera(ref), t_cameras(
                scene.cameras[1:]), 5.0, 3.0, backend="warp",
            color_only_weights=color_only,
            radius_map=None if radius_map is None else _t(radius_map))
        return cj, ct.replace(**{f: _t(getattr(cj, f)) for f in _CTX_FIELDS})

    return dict(scene=scene, plane=plane, degenerate=degenerate, rmap=rmap,
                contexts=contexts)


def _share_close(got, want, tol):
    """Share of entries within ``tol`` (NaN in both counts as equal)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = (np.abs(got - want) <= tol) | (np.isnan(got) & np.isnan(want))
    return float(ok.mean())


@pytest.mark.parametrize("which", ["plane", "degenerate"])
def test_warp_field_plain_matches_jax_exact(setup, which):
    """Within 1e-4 at >= 99.9 % of the entries, in-view equal at >= 99.9 %.
    Measured: equal everywhere (NaN at the same entries for w = 0)."""
    cj, ct = setup["contexts"]()
    plane = setup[which]
    want_w, want_iv = j_ncc.warp_field(cj, jnp.asarray(plane))
    _build.reset_launches()
    got_w, got_iv = ncc.warp_field(ct, _t(plane))
    assert _build.LAUNCHES["warp"] == 0
    assert tuple(got_w.shape) == tuple(got_iv.shape) == (V, H, W)
    close = _share_close(np_(got_w), want_w, 1e-4)
    iv = float((np_(got_iv) == np.asarray(want_iv)).mean())
    nan = int(np.isnan(np_(got_w)).sum())
    print(f"warp field ({which}): within 1e-4 {close:.6f}, in-view equal "
          f"{iv:.6f}, NaN entries {nan}")
    assert close >= 0.999, close
    assert iv >= 0.999, iv
    if which == "degenerate":
        assert nan > 0


def test_warp_field_plain_vs_jax_pallas_interpret(setup):
    """The plain version (fp32 sources) against ``warp_field_pallas`` in
    interpret mode (u8 packed quads): median |d| <= 0.25, max <= 0.6,
    in-view mismatch <= 1 %.  JAX's own pair (check_warpfield_pallas.py):
    0.148 / 0.496 / 0.0.  Measured: 0.148 / 0.496 / 0.0 as well (the u8
    rounding of the sources dominates both)."""
    cj, ct = setup["contexts"]()
    cp = j_ncc.build_cost_context(
        cj.ref_img, cj.src_imgs, setup["scene"].cameras[0],
        stack_cameras(setup["scene"].cameras[1:]), 5.0, 3.0,
        backend="pallas")
    plane = jnp.asarray(setup["plane"])
    n = plane[..., :3]
    wd = jnp.where(jnp.abs(plane[..., 3]) < 1e-12, 1e-12, plane[..., 3])
    invd = -(n[..., 0] * cp.rx + n[..., 1] * cp.ry + n[..., 2]) / wd
    cam = jnp.stack([cp.cam_cx, cp.cam_cy, jnp.asarray(cp.inv_fx, jnp.float32),
                     jnp.asarray(cp.inv_fy, jnp.float32)])
    want_w, want_iv = warp_field_pallas(invd, cp.rx, cp.packed_quads, cp.M,
                                        cp.b, cam, cp.src_wh, interpret=True)
    got_w, got_iv = ncc.warp_field(ct, _t(setup["plane"]))
    d = np.abs(np_(got_w) - np.asarray(want_w))
    mis = float((np_(got_iv) != np.asarray(want_iv)).mean())
    print(f"warp field vs Pallas interpret: median {np.median(d):.3f} "
          f"p99 {np.percentile(d, 99):.3f} max {d.max():.3f} in-view "
          f"mismatch {mis:.4f}")
    assert np.median(d) <= 0.25
    assert d.max() <= 0.6
    assert mis <= 0.01


@pytest.mark.parametrize("rmap", [False, True])
def test_ncc_cost_warp_matches_jax(setup, rmap):
    """The warp-once NCC (static shifts of the static radius; weights with
    the radius map where there is one): within 1e-4 at >= 99.9 % of the
    entries.  Measured: max |d| 1.2e-7 with and without the map."""
    cj, ct = setup["contexts"](radius_map=setup["rmap"] if rmap else None)
    plane = setup["plane"] * np.float32([1.0, 1.0, 1.0, 1.01])
    want = np.asarray(j_ncc._ncc_cost_warp(cj, jnp.asarray(plane)))
    got = np_(ncc.ncc_cost_batch(ct, _t(plane)[None])[0])
    close = _share_close(got, want, 1e-4)
    print(f"warp NCC (radius map {rmap}): within 1e-4 {close:.6f}, max "
          f"{np.nanmax(np.abs(got - want)):.2e}, cost < 2 at "
          f"{(got < 2).mean():.3f}")
    assert got.shape == (H, W, V)
    assert close >= 0.999, close
    assert float((got < 2.0).mean()) > 0.5
    with pytest.raises(ValueError, match="full grid"):
        ncc.ncc_cost_batch(ct, _t(plane)[None], parity=0)


def _anchors(seed=5):
    rng = np.random.default_rng(seed)
    coords = rng.integers(-3, W + 3, (A, H, W, 2)).astype(np.int32)
    coords[..., 1] = rng.integers(-3, H + 3, (A, H, W))
    valid = rng.uniform(size=(A, H, W)) < 0.85
    reliable = rng.uniform(size=(H, W)) < 0.8
    sel = rng.uniform(size=(H, W, V)) < 0.8
    return coords, valid, reliable, sel


@pytest.mark.parametrize("color", [None, 1])
def test_pack_anchor_fields_matches_jax(setup, color):
    """Every field equal (floats within 1e-6), full grid and one
    checkerboard color."""
    cj, ct = setup["contexts"](color_only=True)
    coords, valid, reliable, sel = _anchors()
    ref_img = setup["scene"].images[0]
    j_pk = (lambda a: a) if color is None else (
        lambda a: j_pack_parity(a, color))
    want = j_def.pack_anchor_fields(
        cj, JAnchorResult(jnp.asarray(coords), jnp.asarray(valid),
                          jnp.asarray(reliable)),
        jnp.asarray(sel), jnp.asarray(ref_img), jnp.float32(3.0), j_pk)
    kw = {} if color is None else dict(
        pk=lambda a, axis=0: pack_parity(a, color, axis))
    got = deformable.pack_anchor_fields(
        ct, convert.anchors(dict(coords=coords, valid=valid,
                                 reliable=reliable), device="cpu"),
        _t(sel), _t(ref_img), 3.0, **kw)
    for f in deformable.AnchorFields._fields:
        g, w = np_(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.fixture(scope="module")
def anchor_terms(setup):
    """The candidate-independent anchor term of both packages on the
    (slightly perturbed) ground-truth field, dense anchor fields."""
    cj, ct = setup["contexts"](color_only=True)
    coords, valid, reliable, sel = _anchors()
    ref_img = setup["scene"].images[0]
    anchors_j = JAnchorResult(jnp.asarray(coords), jnp.asarray(valid),
                              jnp.asarray(reliable))
    af_j = j_def.pack_anchor_fields(cj, anchors_j, jnp.asarray(sel),
                                    jnp.asarray(ref_img), jnp.float32(3.0))
    af_t = deformable.AnchorFields(*(_t(x) for x in af_j))
    plane = setup["plane"] * np.float32([1.0, 1.0, 1.0, 1.005])
    want = j_def.anchor_cost_term(cj, jnp.asarray(plane), af_j)
    _build.reset_launches()
    got = deformable.anchor_cost_term(ct, _t(plane), af_t)
    assert _build.LAUNCHES["warp"] == 0
    return dict(cj=cj, ct=ct, af_j=af_j, plane=plane, want=want, got=got)


def test_anchor_cost_term_matches_jax_exact(anchor_terms):
    """has equal; cost within 1e-4 except at <= 1e-3 of the entries (the
    ungrouped NCC of raw intensities amplifies last-bit differences).
    Measured: max |d| 1.8e-7."""
    want, got = anchor_terms["want"], anchor_terms["got"]
    np.testing.assert_array_equal(np_(got.has_anchors),
                                  np.asarray(want.has_anchors))
    diff = np.abs(np_(got.cost) - np.asarray(want.cost))
    share = float((diff > 1e-4).mean())
    print(f"anchor_cost_term vs JAX exact: max {diff.max():.2e} share>1e-4 "
          f"{share:.2e}; cost < 2 at {(np_(got.cost) < 2).mean():.3f}")
    assert tuple(got.cost.shape) == (H, W, V)
    assert share <= 1e-3, share
    assert float((np_(got.cost) < 2.0).mean()) > 0.3


def test_anchor_cost_term_vs_jax_pallas_backend(anchor_terms, setup,
                                                monkeypatch):
    """Against JAX's pallas-backend term, which warps with
    ``warp_field_pallas`` (interpret mode) and quantizes the warped field to
    u8: has equal at >= 99 % (an in-view flip at the border changes it);
    the costs agree by distribution: median |d| <= 0.01, >= 90 % within
    0.05.  Measured: has equal everywhere, median |d| 3.2e-4, all within
    0.05, mean 6.1e-4."""
    cj = anchor_terms["cj"]
    cp = j_ncc.build_cost_context(
        cj.ref_img, cj.src_imgs, setup["scene"].cameras[0],
        stack_cameras(setup["scene"].cameras[1:]), 5.0, 3.0,
        backend="pallas", color_only_weights=True)
    import dvpmvs.kernels.sweep_pallas as sp
    monkeypatch.setattr(sp, "warp_field_pallas", lambda *a, **k: (
        warp_field_pallas(*a, interpret=True, **k)))
    want = j_def.anchor_cost_term(cp, jnp.asarray(anchor_terms["plane"]),
                                  anchor_terms["af_j"])
    got = anchor_terms["got"]
    has_eq = float((np_(got.has_anchors)
                    == np.asarray(want.has_anchors)).mean())
    diff = np.abs(np_(got.cost) - np.asarray(want.cost))
    med = float(np.median(diff))
    within = float((diff <= 0.05).mean())
    print(f"anchor_cost_term vs JAX pallas backend: has equal {has_eq:.4f}, "
          f"median {med:.3e}, share<=0.05 {within:.3f}, mean "
          f"{diff.mean():.3e}")
    assert has_eq >= 0.99
    assert med <= 0.01, med
    assert within >= 0.9, within


def test_deformable_cost_matches_jax(anchor_terms):
    """0.25 center + 0.75 anchor term where it has anchors: within 1e-4
    except at <= 1e-3 of the entries, on the full grid (exact backends;
    the port's context is the warp backend's, whose center window is the
    warp-once NCC, so the JAX context is switched to "warp" too).
    Measured: max |d| 1.2e-7."""
    cj, ct = anchor_terms["cj"], anchor_terms["ct"]
    cj = cj.replace(backend="warp")
    plane = anchor_terms["plane"]
    want = np.asarray(j_def.deformable_cost(cj, jnp.asarray(plane),
                                            anchor_terms["want"]))
    got = np_(deformable.deformable_cost(ct, _t(plane), anchor_terms["got"]))
    diff = np.abs(got - want)
    share = float((diff > 1e-4).mean())
    print(f"deformable_cost vs JAX: max {diff.max():.2e} share>1e-4 "
          f"{share:.2e}")
    assert got.shape == (H, W, V)
    assert share <= 1e-3, share
