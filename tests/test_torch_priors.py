"""The port's host priors against the JAX package's on the same inputs: the
label mode of the depth-edge prior (``roberts``, ``hough_complete``,
``_draw_line``, ``edge_segment(mode=1)``), the native connected-component
labeler against its scipy plain version, and the mono-prior bootstrap
(``align_mono_depth``, ``normals_from_depth``, ``mono_prior_planes``,
``read_sfm_txt``).

Every function here is numpy/scipy on the host, and the port's copies keep
JAX's calls (``np.add.at``, the default ``np.argsort``, ``np.round``,
``np.linspace``), so the results are equal bit for bit.  Label maps are
compared as partitions (the same pixels at -1, the same pixels at 0, a
bijection between the positive ids), because a labeler may number
components in another order; where the numbering matches, they are also
equal (measured: it matches everywhere below, as both labelers number in
raster order of a component's first pixel).
"""

import numpy as np
import pytest

from test_torch_support import assert_same_partition, t_camera

from dvpmvs.geometry.transforms import backproject_cam, cam_to_world
from dvpmvs.priors import edges as j_edges
from dvpmvs.priors import mono as j_mono
from dvpmvs.utils.synthetic import make_scene
from dvpmvs.utils.synthetic import write_scene_dir as j_write_scene_dir

from dvpmvs_torch.kernels import _build
from dvpmvs_torch.priors import edges as t_edges
from dvpmvs_torch.priors import mono as t_mono
from dvpmvs_torch.priors.labeling_native import label as t_label


# ----------------------------------------------------------- label mode --

def test_labeler_source_is_the_native_copy():
    """The port builds its own byte-equal copy of native/labeling.cpp."""
    root = _build.CSRC.parents[1]
    assert ((_build.CSRC / "labeling.cpp").read_bytes()
            == (root / "native" / "labeling.cpp").read_bytes())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roberts_matches_jax(seed):
    img = np.random.default_rng(seed).uniform(0, 255, (37, 53)).astype(
        np.float32)
    got, want = t_edges.roberts(img), j_edges.roberts(img)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,share", [((40, 56), 0.55), ((64, 96), 0.7),
                                         ((17, 23), 0.5)])
def test_native_labeler_matches_scipy(shape, share):
    """The native union-find labeler against scipy's ``ndimage.label`` (the
    plain version) on random masks: the same partition, the same counts
    per component, and (measured) the same numbering."""
    rng = np.random.default_rng(shape[0])
    mask = np.where(rng.random(shape) < share, 0, 255).astype(np.uint8)
    lab, cnt = t_edges.connected_components(mask)
    plab, pcnt = t_edges.connected_components_plain(mask)
    assert lab.dtype == np.int32 and cnt.dtype == np.int64
    assert_same_partition(lab, plab)
    assert cnt[0] == 0 and sorted(cnt[1:]) == sorted(pcnt[1:])
    np.testing.assert_array_equal(cnt[lab], pcnt[plab])
    np.testing.assert_array_equal(lab, plab)
    np.testing.assert_array_equal(cnt, pcnt)
    # and the JAX package's labeler (native where it builds, else scipy)
    jlab, jcnt = j_edges.connected_components(mask)
    assert_same_partition(lab, jlab.astype(np.int32))


def test_native_labeler_on_a_label_map():
    """The non-edge regions of a thresholded Roberts map (what
    edge_segment labels) are labeled as scipy labels them."""
    img = make_scene(num_views=1, height=96, width=128, seed=6).images[0]
    edge = np.where(t_edges.roberts(img) > 4, 255, 0).astype(np.uint8)
    lab, cnt = t_label(edge == 0)
    plab, pcnt = t_edges.connected_components_plain(edge)
    assert len(cnt) > 2
    assert_same_partition(lab, plab)
    np.testing.assert_array_equal(cnt[lab], pcnt[plab])


@pytest.mark.parametrize("seed", [3, 4])
def test_draw_line_matches_jax(seed):
    rng = np.random.default_rng(seed)
    got = np.zeros((40, 60), np.uint8)
    want = got.copy()
    for _ in range(6):
        r = rng.uniform(-20, 60)
        theta = rng.uniform(0, np.pi)
        t0 = rng.uniform(-50, 20)
        args = (r, np.cos(theta), np.sin(theta), t0, t0 + rng.uniform(0, 60))
        t_edges._draw_line(got, *args)
        j_edges._draw_line(want, *args)
    assert got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [6, 2])
def test_hough_complete_matches_jax(seed):
    """hough_complete on the quarter-size Roberts edge map of a scene image,
    with a component threshold low enough that several regions are big."""
    img = make_scene(num_views=1, height=256, width=320, seed=seed,
                     weak_band=True).images[0]
    small = t_edges._resize_linear(img.astype(np.float32), (64, 80))
    edge = np.where(t_edges.roberts(small) > 4, 255, 0).astype(np.uint8)
    lab, cnt = t_edges.connected_components(edge)
    args = (edge, lab, cnt, 40, 2, 2, 2)
    got, want = t_edges.hough_complete(*args), j_edges.hough_complete(*args)
    assert (got != edge).any()            # lines were drawn
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [0, 1, 2])
@pytest.mark.parametrize("kw", [dict(height=96, width=128, seed=6),
                                dict(height=128, width=160, seed=2,
                                     weak_band=True)],
                         ids=["96x128", "band128x160"])
def test_edge_segment_label_mode_matches_jax(scale, kw):
    """edge_segment(mode=1, use_canny=False) on make_scene images at scales
    0-2: the same partition as JAX's at every pixel (and the same ids)."""
    sc = make_scene(num_views=3, **kw)
    regions = 0
    for img in sc.images:
        got = t_edges.edge_segment(scale, img, mode=1, use_canny=False)
        want = j_edges.edge_segment(scale, img, mode=1, use_canny=False)
        H, W = img.shape
        assert got.shape == (round(H / 2 ** scale), round(W / 2 ** scale))
        assert_same_partition(got, want)
        np.testing.assert_array_equal(got, want)
        regions += len(np.unique(got[got > 0]))
    assert regions > 0


@pytest.mark.parametrize("mode,use_canny", [(0, False), (1, True)])
def test_edge_segment_other_modes_match_jax(mode, use_canny):
    """The Roberts edge mask and the Canny label map."""
    img = make_scene(num_views=1, height=96, width=128, seed=6).images[0]
    got = t_edges.edge_segment(1, img, mode=mode, use_canny=use_canny)
    want = j_edges.edge_segment(1, img, mode=mode, use_canny=use_canny)
    assert got.dtype == want.dtype
    if mode == 1:
        assert_same_partition(got, want)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ mono --

def _sparse_points(sc, v, step=8):
    """The ground truth's back-projections on a grid (JAX's transforms), as
    tests/test_priors.py makes them."""
    import jax.numpy as jnp
    cam = sc.cameras[v]
    gt = sc.gt_depth[v]
    H, W = gt.shape
    ys, xs = np.mgrid[4:H:step, 4:W:step]
    Xw = np.asarray(cam_to_world(backproject_cam(
        jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32),
        jnp.asarray(gt[ys, xs], jnp.float32), cam), cam))
    return np.stack([xs.ravel(), ys.ravel()], -1), Xw.reshape(-1, 3)


@pytest.mark.parametrize("noise", [0.0, 3.0])
def test_align_mono_depth_matches_jax(noise):
    sc = make_scene(num_views=2, height=48, width=64, seed=7)
    gt = sc.gt_depth[0].astype(np.float64)
    rng = np.random.default_rng(1)
    mono = (255.0 - 30.0 * gt + noise * rng.standard_normal(gt.shape)
            ).astype(np.float32)
    xy, xyz = _sparse_points(sc, 0)
    got = t_mono.align_mono_depth(mono, xy, xyz, t_camera(sc.cameras[0]))
    want = j_mono.align_mono_depth(mono, xy, xyz, sc.cameras[0])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if noise == 0.0:
        rel = np.abs(got - gt) / gt
        assert np.median(rel[8:-8, 8:-8]) < 0.02


def test_align_mono_depth_few_or_collinear_points_match_jax():
    """Fewer than 4 points in view: the inverted map; collinear points: no
    triangulation, the median ratio everywhere."""
    sc = make_scene(num_views=1, height=48, width=64, seed=7)
    mono = np.random.default_rng(2).uniform(0, 255, (48, 64)).astype(
        np.float32)
    xy, xyz = _sparse_points(sc, 0)
    row = xy[:, 1] == xy[0, 1]
    for sel in (slice(0, 3), row):
        got = t_mono.align_mono_depth(mono, xy[sel], xyz[sel],
                                      t_camera(sc.cameras[0]))
        want = j_mono.align_mono_depth(mono, xy[sel], xyz[sel],
                                       sc.cameras[0])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("to_world", [False, True])
def test_normals_from_depth_matches_jax(to_world):
    sc = make_scene(num_views=1, height=48, width=64, seed=8)
    got = t_mono.normals_from_depth(sc.gt_depth[0], t_camera(sc.cameras[0]),
                                    to_world=to_world)
    want = j_mono.normals_from_depth(sc.gt_depth[0], sc.cameras[0],
                                     to_world=to_world)
    np.testing.assert_array_equal(got, want)
    if not to_world:
        dots = np.sum(got[8:-8, 8:-8] * sc.gt_normal[0][8:-8, 8:-8], -1)
        assert np.mean(dots > 0.95) > 0.8


@pytest.mark.parametrize("target_hw", [None, (24, 32)])
def test_mono_prior_planes_match_jax(target_hw):
    sc = make_scene(num_views=1, height=48, width=64, seed=7)
    mono = (255.0 - 30.0 * sc.gt_depth[0]).astype(np.float32)
    xy, xyz = _sparse_points(sc, 0)
    got = t_mono.mono_prior_planes(mono, xy, xyz, t_camera(sc.cameras[0]),
                                   target_hw=target_hw)
    want = j_mono.mono_prior_planes(mono, xy, xyz, sc.cameras[0],
                                    target_hw=target_hw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_read_sfm_txt_matches_jax(tmp_path):
    """The sfm/ files write_scene_dir(with_sfm=True) writes, and an empty
    one."""
    sc = make_scene(num_views=2, height=24, width=32, seed=4)
    folder = j_write_scene_dir(sc, tmp_path / "d", with_sfm=True,
                               sfm_points=30)
    (folder / "sfm" / "empty.txt").write_text("")
    for name in ("00000000.txt", "00000001.txt", "empty.txt"):
        got = t_mono.read_sfm_txt(folder / "sfm" / name)
        want = j_mono.read_sfm_txt(folder / "sfm" / name)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got[0].shape == (0, 2)
