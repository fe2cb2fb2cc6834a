"""The port's COLMAP converter (``dvpmvs_torch/io/colmap.py``, its own copy
of the reference's numpy module) against the JAX package's: every reader
on a text model (tests/test_colmap_cli.py's) and on a binary one written
here with ``struct``, the view selection and depth ranges, ``convert_colmap``
byte for byte, and the CLI's ``convert`` and ``synth`` commands (then
``scene`` on the synthetic folder) on the CPU."""

import struct

import numpy as np
import pytest

from test_colmap_cli import _write_text_model

from dvpmvs.io import colmap as j_colmap

from dvpmvs_torch.cli.run import main as t_cli
from dvpmvs_torch.io import colmap as t_colmap
from dvpmvs_torch.io import read_ply

_MODEL_IDS = {"PINHOLE": 1, "SIMPLE_RADIAL": 2}


def _write_binary_model(model_dir, seed=1):
    """A two-camera binary model: cameras.bin, images.bin, points3D.bin in
    COLMAP's layout (little-endian, the readers' formats)."""
    rng = np.random.default_rng(seed)
    model_dir.mkdir(parents=True, exist_ok=True)
    cams = [(1, "PINHOLE", 64, 48, [60.0, 61.0, 32.0, 24.0]),
            (2, "SIMPLE_RADIAL", 64, 48, [58.0, 31.5, 23.5, 0.01])]
    with open(model_dir / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, model, w, h, params in cams:
            f.write(struct.pack("<iiQQ", cid, _MODEL_IDS[model], w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))
    n_pts, n_img = 40, 3
    pts = rng.uniform([-1, -1, 3], [1, 1, 5], size=(n_pts, 3))
    tracks = {p: [] for p in range(n_pts)}
    with open(model_dir / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_img))
        for i in range(n_img):
            q = rng.standard_normal(4) * 0.05 + np.array([1.0, 0, 0, 0])
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i4d3di", i + 1, *q, 0.1 * i, 0.0, 0.0,
                                1 + i % 2))
            f.write(f"im{i}.png".encode() + b"\x00")
            obs = [p for p in range(n_pts) if rng.uniform() < 0.7]
            f.write(struct.pack("<Q", len(obs) + 1))
            for p in obs:
                f.write(struct.pack("<ddq", *rng.uniform(0, 48, 2), p + 1))
                tracks[p].append((i + 1, len(tracks[p])))
            f.write(struct.pack("<ddq", 5.0, 6.0, -1))
    with open(model_dir / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n_pts))
        for p in range(n_pts):
            f.write(struct.pack("<Q3d3Bd", p + 1, *pts[p], 100, 120, 140,
                                0.5))
            f.write(struct.pack("<Q", len(tracks[p])))
            for iid, k in tracks[p]:
                f.write(struct.pack("<ii", iid, k))
    return model_dir


def _assert_same_model(got, want):
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            for field in vars(w[k]):
                a, b = getattr(g[k], field), getattr(w[k], field)
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype, field
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b, field


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_readers_match_jax(tmp_path, ext):
    """cameras, images, points3D (and K, R of each) equal JAX's; the view
    selection scores and depth ranges too."""
    model = tmp_path / "sparse"
    if ext == ".txt":
        _write_text_model(model)
    else:
        _write_binary_model(model)
    got = t_colmap.read_model(model, ext=ext)
    want = j_colmap.read_model(model, ext=ext)
    _assert_same_model(got, want)
    assert len(got[1]) == 3 and len(got[2]) > 30
    for cid in want[0]:
        np.testing.assert_array_equal(got[0][cid].K, want[0][cid].K)
    for iid in want[1]:
        np.testing.assert_array_equal(got[1][iid].R, want[1][iid].R)
        assert (t_colmap.depth_range_for(got[1][iid], got[2])
                == j_colmap.depth_range_for(want[1][iid], want[2]))
    np.testing.assert_array_equal(
        t_colmap.view_selection_scores(got[1], got[2]),
        j_colmap.view_selection_scores(want[1], want[2]))
    q = np.random.default_rng(3).standard_normal(4)
    np.testing.assert_array_equal(t_colmap.qvec2rotmat(q / np.linalg.norm(q)),
                                  j_colmap.qvec2rotmat(q / np.linalg.norm(q)))


def _dense_with_images(dense):
    """tests/test_colmap_cli.py's text model, and its three images at two
    sizes (the converter pads them to the largest)."""
    from PIL import Image
    _write_text_model(dense / "sparse")
    (dense / "images").mkdir()
    rng = np.random.default_rng(5)
    for v, (h, w) in enumerate(((48, 64), (46, 64), (48, 60))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(dense / "images" / f"im{v}.png")
    return dense


def _assert_same_tree(got_root, want_root, n_files):
    got = sorted(p.relative_to(got_root)
                 for p in got_root.rglob("*") if p.is_file())
    want = sorted(p.relative_to(want_root)
                  for p in want_root.rglob("*") if p.is_file())
    assert got == want and len(got) == n_files
    for rel in want:
        assert (got_root / rel).read_bytes() == (want_root / rel).read_bytes(
        ), rel


@pytest.mark.parametrize("scale_factor", [1, 2])
def test_convert_colmap_matches_jax(tmp_path, scale_factor):
    """convert_colmap of both packages: cams, pair.txt, sfm/ and the
    images, every file byte for byte."""
    dense = _dense_with_images(tmp_path / "dense")
    t_colmap.convert_colmap(dense, tmp_path / "t", scale_factor=scale_factor)
    j_colmap.convert_colmap(dense, tmp_path / "j", scale_factor=scale_factor)
    _assert_same_tree(tmp_path / "t", tmp_path / "j", 3 * 3 + 1)


def test_cli_convert_synth_and_scene(tmp_path):
    """``convert`` writes JAX's command's files; ``synth`` writes JAX's
    command's scene folder, which ``scene --device cpu`` runs to a fused
    cloud."""
    from dvpmvs.cli.run import main as j_cli
    dense = _dense_with_images(tmp_path / "dense")
    conv = ["--max-d", "64", "--scale-factor", "2"]
    assert t_cli(["convert", str(dense), str(tmp_path / "t_mvs")] + conv) == 0
    assert j_cli(["convert", str(dense), str(tmp_path / "j_mvs")] + conv) == 0
    _assert_same_tree(tmp_path / "t_mvs", tmp_path / "j_mvs", 3 * 3 + 1)
    synth = ["--views", "3", "--height", "32", "--width", "48", "--seed", "4"]
    assert t_cli(["synth", str(tmp_path / "sc")] + synth) == 0
    assert j_cli(["synth", str(tmp_path / "j_sc")] + synth) == 0
    _assert_same_tree(tmp_path / "sc", tmp_path / "j_sc", 3 * 2 + 1)
    out = tmp_path / "out"
    assert t_cli(["scene", str(tmp_path / "sc"), "--device", "cpu",
                  "--output", str(out), "--iterations", "1",
                  "--geometric-passes", "1", "--max-src-views", "2",
                  "--backend", "exact"]) == 0
    pts, cols = read_ply(out / "APD.ply")
    assert len(pts) > 0 and cols.shape == pts.shape
