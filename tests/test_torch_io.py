"""The port's I/O and support modules against the JAX package's on the same
inputs: the binary matrix and .dmb containers, cam.txt / pair.txt, PLY,
the scene loader and ``write_scene_dir`` (numpy copies: the same bytes),
``scale_camera``, ``SceneConfig``, ``connected_components`` (scipy path),
the weak-state PNG, ``Metrics`` and the profiler trace.  Inputs come from a
numpy seed or ``make_scene``.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (caps torch's threads)
from test_torch_support import t_camera

from dvpmvs import config as j_config
from dvpmvs import io as j_io
from dvpmvs.geometry.camera import scale_camera as j_scale_camera
from dvpmvs.io.ply import export_depth_point_cloud as j_export
from dvpmvs.priors.edges import connected_components as j_cc
from dvpmvs.utils import viz as j_viz
from dvpmvs.utils.synthetic import make_scene as j_make_scene
from dvpmvs.utils.synthetic import write_scene_dir as j_write_scene_dir

from dvpmvs_torch import config as t_config
from dvpmvs_torch import io as t_io
from dvpmvs_torch.geometry.camera import scale_camera as t_scale_camera
from dvpmvs_torch.io import scene as t_scene
from dvpmvs_torch.io.ply import export_depth_point_cloud as t_export
from dvpmvs_torch.priors.edges import connected_components as t_cc
from dvpmvs_torch.utils import profiling, viz as t_viz
from dvpmvs_torch.utils.synthetic import make_scene as t_make_scene
from dvpmvs_torch.utils.synthetic import write_scene_dir as t_write_scene_dir


def _bytes(path):
    return path.read_bytes()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("dtype,channels", [
    (np.float32, 1), (np.uint8, 1), (np.int8, 1), (np.int32, 1),
    (np.float32, 3)])
def test_bin_mat_matches_jax(tmp_path, dtype, channels):
    """write_bin_mat writes JAX's bytes; each package reads the other's."""
    rng = np.random.default_rng(0)
    shape = (17, 23) if channels == 1 else (17, 23, channels)
    arr = (rng.standard_normal(shape) * 50).astype(dtype)
    t_io.write_bin_mat(tmp_path / "t.bin", arr)
    j_io.write_bin_mat(tmp_path / "j.bin", arr)
    assert _bytes(tmp_path / "t.bin") == _bytes(tmp_path / "j.bin")
    back = t_io.read_bin_mat(tmp_path / "j.bin")
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(j_io.read_bin_mat(tmp_path / "t.bin"), arr)


def test_dmb_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    d = rng.standard_normal((9, 11)).astype(np.float32)
    n = rng.standard_normal((9, 11, 3)).astype(np.float32)
    for pkg, tag in ((t_io, "t"), (j_io, "j")):
        pkg.write_depth_dmb(tmp_path / f"{tag}d.dmb", d)
        pkg.write_normal_dmb(tmp_path / f"{tag}n.dmb", n)
    assert _bytes(tmp_path / "td.dmb") == _bytes(tmp_path / "jd.dmb")
    assert _bytes(tmp_path / "tn.dmb") == _bytes(tmp_path / "jn.dmb")
    np.testing.assert_array_equal(t_io.read_dmb(tmp_path / "jd.dmb"), d)
    np.testing.assert_array_equal(t_io.read_dmb(tmp_path / "jn.dmb"), n)
    (tmp_path / "bad.dmb").write_bytes(np.array([2, 1, 1, 1], np.int32)
                                       .tobytes())
    with pytest.raises(ValueError, match="dmb type"):
        t_io.read_dmb(tmp_path / "bad.dmb")


def test_cam_and_pair_txt_match_jax(tmp_path):
    """cam.txt from the same camera: the same text; read back, the same
    float32 fields.  pair.txt: the same text and the same parse, score <= 0
    dropped."""
    jcam = j_make_scene(num_views=2, height=32, width=40, seed=3).cameras[1]
    j_io.write_cam_txt(tmp_path / "j_cam.txt", jcam, interval=2.5)
    t_io.write_cam_txt(tmp_path / "t_cam.txt", t_camera(jcam), interval=2.5)
    assert _bytes(tmp_path / "t_cam.txt") == _bytes(tmp_path / "j_cam.txt")
    tcam = t_io.read_cam_txt(tmp_path / "j_cam.txt")
    jback = j_io.read_cam_txt(tmp_path / "j_cam.txt")
    for f in ("K", "R", "t", "depth_min", "depth_max"):
        got = getattr(tcam, f)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jback, f)))
    pairs = [(0, [(1, 12.5), (2, 0.0), (3, 7.25)]), (1, [(0, 3.0)]),
             (2, [])]
    j_io.write_pair_txt(tmp_path / "j_pair.txt", pairs)
    t_io.write_pair_txt(tmp_path / "t_pair.txt", pairs)
    assert _bytes(tmp_path / "t_pair.txt") == _bytes(tmp_path / "j_pair.txt")
    assert (t_io.read_pair_txt(tmp_path / "j_pair.txt")
            == j_io.read_pair_txt(tmp_path / "j_pair.txt"))
    assert t_io.read_pair_txt(tmp_path / "j_pair.txt")[0][1] == [
        (1, 12.5), (3, 7.25)]
    (tmp_path / "bad.txt").write_text("intrinsic 1 2 3")
    with pytest.raises(ValueError, match="extrinsic"):
        t_io.read_cam_txt(tmp_path / "bad.txt")


def test_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((57, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (57, 3)).astype(np.uint8)
    t_io.write_ply(tmp_path / "t.ply", pts, cols)
    j_io.write_ply(tmp_path / "j.ply", pts, cols)
    assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")
    p2, c2 = t_io.read_ply(tmp_path / "j.ply")
    np.testing.assert_array_equal(p2, pts)
    np.testing.assert_array_equal(c2, cols)
    t_io.write_ply(tmp_path / "e.ply", pts[:0], cols[:0])
    assert t_io.read_ply(tmp_path / "e.ply")[0].shape == (0, 3)


def test_export_depth_point_cloud_matches_jax(tmp_path):
    s = j_make_scene(num_views=1, height=24, width=32, seed=5)
    rgb = np.random.default_rng(3).integers(0, 256, (24, 32, 3)).astype(
        np.uint8)
    d = s.gt_depth[0].copy()
    d[:3] = 0.0
    args = (d, rgb, float(s.cameras[0].depth_min),
            float(s.cameras[0].depth_max))
    j_export(tmp_path / "j.ply", d, s.cameras[0], *args[1:])
    t_export(tmp_path / "t.ply", d, t_camera(s.cameras[0]), *args[1:])
    assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")
    assert len(t_io.read_ply(tmp_path / "t.ply")[0]) > 0


@pytest.mark.parametrize("kw,sfm", [
    (dict(num_views=3, height=24, width=32, seed=4), {}),
    (dict(num_views=5, height=17, width=23, seed=9), {}),
    (dict(num_views=3, height=24, width=32, seed=4),
     dict(with_sfm=True, sfm_points=50))], ids=["3views", "5views", "sfm"])
def test_write_scene_dir_matches_jax(tmp_path, kw, sfm):
    """The port's make_scene + write_scene_dir write JAX's files, byte for
    byte (images, cameras and pair.txt; with ``with_sfm`` the sfm/ points
    too)."""
    j_write_scene_dir(j_make_scene(**kw), tmp_path / "j", **sfm)
    t_write_scene_dir(t_make_scene(**kw), tmp_path / "t", **sfm)
    want, got = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert sorted(got) == sorted(want)
    assert len(got) == (3 if sfm else 2) * kw["num_views"] + 1
    for name in want:
        assert got[name] == want[name], name


def test_load_scene_matches_jax(tmp_path):
    s = t_make_scene(num_views=4, height=24, width=32, seed=1)
    folder = t_write_scene_dir(s, tmp_path / "dense")
    want = j_io.load_scene(folder, max_src_views=2, load_colors=True)
    got = t_io.load_scene(folder, max_src_views=2, load_colors=True)
    assert got.image_ids == want.image_ids == [0, 1, 2, 3]
    assert got.num_views == 4 and got.image_size(0) == (32, 24)
    for a, b in zip(got.problems, want.problems):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for i in want.image_ids:
        np.testing.assert_array_equal(got.images[i], want.images[i])
        np.testing.assert_array_equal(got.colors[i], want.colors[i])
        assert got.colors[i].dtype == np.uint8
        for f in ("K", "R", "t", "depth_min", "depth_max"):
            np.testing.assert_array_equal(
                getattr(got.cameras[i], f).numpy(),
                np.asarray(getattr(want.cameras[i], f)))
    assert t_scene.format_index(7) == "00000007"
    with pytest.raises(FileNotFoundError):
        t_scene._find_image(folder / "images", 9)


def test_image_files_need_pil(tmp_path, monkeypatch):
    """With PIL, .png decodes as JAX's loader decodes it; without it a .png
    raises a clear error while .npy still loads."""
    from PIL import Image
    rgb = np.random.default_rng(6).integers(0, 256, (8, 10, 3)).astype(
        np.uint8)
    Image.fromarray(rgb).save(tmp_path / "00000000.png")
    np.testing.assert_array_equal(
        t_scene.load_image_gray(tmp_path / "00000000.png"),
        j_io.scene.load_image_gray(tmp_path / "00000000.png"))
    np.testing.assert_array_equal(
        t_scene.load_image_color(tmp_path / "00000000.png"), rgb)
    np.save(tmp_path / "g.npy", rgb[..., 0].astype(np.float32))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        t_scene.load_image_gray(tmp_path / "00000000.png")
    assert t_scene.load_image_color(tmp_path / "g.npy").shape == (8, 10, 3)


def test_scale_camera_matches_jax():
    jcam = j_make_scene(num_views=1, height=30, width=40, seed=7).cameras[0]
    for sx, sy in ((0.5, 0.5), (401 / 800, 303 / 608), (2.0, 1.0)):
        want = j_scale_camera(jcam, sx, sy)
        got = t_scale_camera(t_camera(jcam), sx, sy)
        for f in ("K", "R", "t", "depth_min", "depth_max"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


def test_scene_config_matches_jax():
    """The port keeps the fields of JAX's SceneConfig that its runner reads,
    with JAX's defaults."""
    fields = lambda cls: {f.name: f.default for f in dataclasses.fields(cls)}
    want, got = fields(j_config.SceneConfig), fields(t_config.SceneConfig)
    assert sorted(got) == sorted([
        "max_base_size", "geometric_passes", "show_medium_result",
        "full_res_round", "seed", "mesh_views", "mesh_tiles"])
    assert got == {k: want[k] for k in got}


def test_connected_components_matches_jax():
    """The same components and per-component counts (label numbering may
    differ: JAX prefers its native labeler where it builds)."""
    rng = np.random.default_rng(8)
    edge = np.where(rng.uniform(size=(40, 50)) < 0.45, 255, 0).astype(
        np.uint8)
    jl, jc = j_cc(edge)
    tl, tc = t_cc(edge)
    assert tl.dtype == np.int32 and tc.dtype == np.int64
    assert ((tl == 0) == (jl == 0)).all() and tc[0] == 0
    np.testing.assert_array_equal(tc[tl], jc[jl])
    # one label per component on each side
    pairs = set(zip(tl.ravel().tolist(), jl.ravel().tolist()))
    assert len(pairs) == len(set(tl.ravel().tolist())) == len(jc)


def test_weak_png_matches_jax(tmp_path):
    """The port's stdlib PNG decodes (PIL) to the pixels of JAX's."""
    from PIL import Image
    weak = np.random.default_rng(9).integers(0, 3, (13, 21)).astype(np.int8)
    t_viz.write_weak_viz(tmp_path / "t.png", weak)
    j_viz.write_weak_viz(tmp_path / "j.png", weak)
    got = Image.open(tmp_path / "t.png")
    assert got.mode == "RGB" and got.size == (21, 13)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    with pytest.raises(ValueError, match="PNG"):
        t_viz.write_weak_viz(tmp_path / "t.jpg", weak)


def test_metrics_and_trace(tmp_path):
    """Metrics: spans and counters, as JAX's; trace writes a Chrome trace
    holding the annotated span; no trace without a directory."""
    from dvpmvs.utils.profiling import Metrics as JMetrics
    m, jm = profiling.Metrics(), JMetrics()
    for rec in (m, jm):
        for _ in range(2):
            with rec.timed("round0/pass0"):
                pass
        rec.count("view_passes", 3)
    s, js = m.summary(), jm.summary()
    assert s["counters"] == js["counters"] == {"view_passes": 3.0}
    assert s["timings"].keys() == js["timings"].keys()
    assert s["timings"]["round0/pass0"]["count"] == 2
    m.dump(tmp_path / "m.json")
    assert json.loads((tmp_path / "m.json").read_text())["counters"] == {
        "view_passes": 3.0}
    with profiling.trace(tmp_path / "tr"):
        with profiling.annotate("round0/pass1"):
            torch.ones(4).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "round0/pass1"
               for e in events["traceEvents"])
    with profiling.trace(None):
        pass
