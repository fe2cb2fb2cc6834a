"""The "warp" cost backend's NCC of a candidate batch
(``warp_fused.warp_ncc``, one launch of ``csrc/warp.cu``'s
``launch_warp_ncc`` a batch on the card) on the CPU, where it runs its
plain version ``warp_ncc_plain``.

Setup: a 40 x 56 grid with V = 3 source views (a seed-4 scene), B = 3
plane fields (the ground truth, a perturbed copy, and a copy with w = 0 in
a block of pixels: NaN coordinates there), with and without a radius map.
The taps' 5-pixel shifts wrap at every border of so small a grid.  The JAX
side runs op by op (not jitted), on contexts whose fields the port's
contexts carry, so that each test holds one function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import np_, t_camera, t_cameras

from dvpmvs.geometry import stack_cameras
from dvpmvs.geometry.transforms import dist_to_origin
from dvpmvs.kernels import ncc as j_ncc
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch.kernels import _build, ncc, warp_fused

H, W, V, B = 40, 56, 3, 3
_CTX_FIELDS = ("M", "b", "w_taps", "wref_taps", "sum_w", "sum_wref",
               "sum_wref2", "radius", "rx", "ry", "src_wh")


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=4)
    ref = scene.cameras[0]
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    n = scene.gt_normal[0]
    w = np.asarray(dist_to_origin(jnp.asarray(n), jnp.asarray(xs),
                                  jnp.asarray(ys),
                                  jnp.asarray(scene.gt_depth[0]), ref))
    plane = np.concatenate([n, w[..., None]], -1).astype(np.float32)
    rng = np.random.default_rng(3)
    perturbed = plane.copy()
    perturbed[..., 3] *= 1.0 + 0.1 * (rng.random((H, W)) - 0.5)
    degenerate = plane.copy()
    degenerate[10:14, 20:40, 3] = 0.0
    planes = np.stack([plane, perturbed.astype(np.float32), degenerate])
    rmap = rng.uniform(3.0, 7.0, (H, W)).astype(np.float32)

    def contexts(radius_map=None):
        cj = j_ncc.build_cost_context(
            jnp.asarray(scene.images[0]), jnp.asarray(scene.images[1:]), ref,
            stack_cameras(scene.cameras[1:]), 5.0, 3.0, backend="exact",
            radius_map=None if radius_map is None else jnp.asarray(
                radius_map))
        ct = ncc.build_cost_context(
            _t(scene.images[0]), _t(scene.images[1:]), t_camera(ref),
            t_cameras(scene.cameras[1:]), 5.0, 3.0, backend="warp",
            radius_map=None if radius_map is None else _t(radius_map))
        return cj, ct.replace(**{f: _t(getattr(cj, f)) for f in _CTX_FIELDS})

    return dict(planes=planes, rmap=rmap, contexts=contexts)


def _args(ct, planes):
    return (planes, ct.src_imgs, ct.M, ct.b, ct.cam, ct.src_wh, ct.w_taps,
            ct.wref_taps, ct.sum_w, ct.sum_wref, ct.sum_wref2,
            ct.strong_radius)


def _ncc_cost_warp_per_plane(ctx, plane):
    """The warp backend's cost of one plane as the port computed it before
    the batch kernel: K5's plain field, 36 rolled copies summed tap by tap,
    then the NCC."""
    warped, in_view = warp_fused.warp_field_plain(
        plane, ctx.src_imgs, ctx.M, ctx.b, ctx.cam, ctx.src_wh)
    taps = ncc.tap_grid()
    r = ctx.strong_radius
    s1 = s2 = s3 = 0.0
    for t in range(taps.shape[0]):
        dxi = int(round(float(taps[t, 0]) * r))
        dyi = int(round(float(taps[t, 1]) * r))
        src_t = torch.roll(warped, shifts=(-dyi, -dxi), dims=(-2, -1))
        wv = ctx.w_taps[t] * src_t
        s1 = s1 + wv
        s2 = s2 + wv * src_t
        s3 = s3 + ctx.wref_taps[t] * src_t
    return ncc._ncc_from_moments(1.0 / ctx.sum_w, ctx.sum_wref,
                                 ctx.sum_wref2, s1, s2, s3, in_view)


@pytest.mark.parametrize("rmap", [False, True])
def test_warp_ncc_on_the_cpu_equals_the_per_plane_costs(setup, rmap):
    """The wrapper on CPU tensors runs the plain version, launches nothing,
    and equals the stack of per-plane warp costs bit for bit (NaN at the
    same entries); ``ncc_cost_batch`` returns the same."""
    _, ct = setup["contexts"](setup["rmap"] if rmap else None)
    planes = _t(setup["planes"])
    _build.reset_launches()
    kernel_planes = warp_fused.KERNEL_PLANES["ncc"]
    got = warp_fused.warp_ncc(*_args(ct, planes))
    assert _build.LAUNCHES["warp"] == 0
    assert warp_fused.KERNEL_PLANES["ncc"] == kernel_planes
    want = torch.stack([_ncc_cost_warp_per_plane(ct, p) for p in planes])
    assert tuple(got.shape) == (B, H, W, V)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[2]).any())
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])
    batches = ncc.BATCHES_EVALUATED["warp"]
    via = ncc.ncc_cost_batch(ct, planes)
    assert ncc.BATCHES_EVALUATED["warp"] == batches + 1
    assert torch.equal(via[ok], want[ok])


@pytest.mark.parametrize("rmap", [False, True])
def test_warp_ncc_matches_jax_plane_by_plane(setup, rmap):
    """Against JAX's eager ``_ncc_cost_warp`` of each plane: within 1e-4 at
    >= 99.9 % of the entries (test_torch_warp.py's bound for one plane),
    NaN counted as agreement where both have it."""
    cj, ct = setup["contexts"](setup["rmap"] if rmap else None)
    got = np_(warp_fused.warp_ncc(*_args(ct, _t(setup["planes"]))))
    for k, plane in enumerate(setup["planes"]):
        want = np.asarray(j_ncc._ncc_cost_warp(cj, jnp.asarray(plane)))
        ok = (np.abs(got[k] - want) <= 1e-4) | (np.isnan(got[k])
                                                 & np.isnan(want))
        print(f"plane {k} (radius map {rmap}): within 1e-4 "
              f"{ok.mean():.6f}, cost < 2 at {(want < 2).mean():.3f}")
        assert float(ok.mean()) >= 0.999, (k, float(ok.mean()))
    assert float((got[0] < 2.0).mean()) > 0.5


@pytest.mark.parametrize("r", range(1, 10))
def test_tap_shift_table_is_the_plain_versions(setup, r, monkeypatch):
    """The [2, 36] table handed to the kernel equals the shifts of JAX's
    ``_ncc_cost_warp`` at radius r, and the plain version reads the
    warped field at exactly those shifts, in tap order."""
    taps = j_ncc.tap_grid()
    want = np.array([[int(round(float(taps[t, k]) * r))
                      for t in range(taps.shape[0])] for k in (0, 1)])
    table = warp_fused.tap_shifts(r)
    assert table.dtype == np.int32 and table.shape == (2, 36)
    np.testing.assert_array_equal(table, want)
    seen = []
    real = warp_fused.shift2

    def recording(arr, dx, dy):
        seen.append((dx, dy))
        return real(arr, dx, dy)

    monkeypatch.setattr(warp_fused, "shift2", recording)
    _, ct = setup["contexts"]()
    warp_fused.warp_ncc(*_args(ct.replace(strong_radius=r),
                               _t(setup["planes"][:1])))
    assert seen == [tuple(int(v) for v in col) for col in want.T]


def test_warp_ncc_raises_and_never_falls_back(setup):
    """A device that is neither the CPU nor a card and inconsistent shapes
    raise; the plain version is never taken for them.  (A halo too large
    for a card's block is refused on the card only: test_torch_cuda.py.)"""
    _, ct = setup["contexts"]()
    planes = _t(setup["planes"])
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t
            for t in _args(ct, planes)]
    _build.reset_launches()
    with pytest.raises(ValueError, match="unsupported device"):
        warp_fused.warp_ncc(*meta)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        warp_fused.warp_ncc(*_args(ct, planes[:, :-1]))
    assert _build.LAUNCHES["warp"] == 0


def test_warp_ncc_on_the_cpu_takes_any_radius(setup):
    """On CPU tensors a radius whose halo no card block could hold (60:
    shifts of up to 60 pixels, wrapping more than once on 40 x 56) still
    runs the plain version, equal to the per-plane costs bit for bit."""
    _, ct = setup["contexts"]()
    ct = ct.replace(strong_radius=60)
    planes = _t(setup["planes"][:2])
    assert int(np.abs(warp_fused.tap_shifts(60)).max()) == 60
    got = warp_fused.warp_ncc(*_args(ct, planes))
    want = torch.stack([_ncc_cost_warp_per_plane(ct, p) for p in planes])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])
