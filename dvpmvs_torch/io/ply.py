"""Binary PLY point-cloud export/import (a copy of ``dvpmvs/io/ply.py``;
the same bytes).

Matches the reference writer (``ExportPointCloud``, APD.cpp:842-882):
binary_little_endian 1.0, per-vertex float x y z + uchar b g r (note BGR
channel order, an OpenCV heritage the benchmark tooling expects).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np

_PathLike = Union[str, Path]


def write_ply(path: _PathLike, points: np.ndarray, colors_bgr: np.ndarray) -> None:
    """points [N,3] float; colors_bgr [N,3] uint8 in BGR order."""
    points = np.ascontiguousarray(points, np.float32)
    colors_bgr = np.ascontiguousarray(colors_bgr, np.uint8)
    n = points.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "property uchar blue\n"
        "property uchar green\n"
        "property uchar red\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=[("xyz", np.float32, 3), ("bgr", np.uint8, 3)])
    rec["xyz"] = points
    rec["bgr"] = colors_bgr
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: _PathLike) -> Tuple[np.ndarray, np.ndarray]:
    """Read a binary PLY written by ``write_ply`` -> (points, colors_bgr)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = 0
        for line in header.decode("ascii", "ignore").splitlines():
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
        rec = np.frombuffer(
            f.read(), dtype=[("xyz", np.float32, 3), ("bgr", np.uint8, 3)],
            count=n)
    return rec["xyz"].copy(), rec["bgr"].copy()


def export_depth_point_cloud(path: _PathLike, depth: np.ndarray,
                             camera, image_rgb: np.ndarray,
                             depth_min: float, depth_max: float) -> None:
    """Single-view depth-map -> PLY debug dump (ExportDepthImagePointCloud,
    APD.cpp:2281-2314): every pixel with depth in [depth_min, depth_max]
    back-projects to world with its image color.  ``camera`` is the port's
    ``Camera`` (tensors on any device)."""
    H, W = depth.shape
    ys, xs = np.mgrid[0:H, 0:W]
    ok = np.isfinite(depth) & (depth >= depth_min) & (depth <= depth_max)
    z = depth[ok]
    rx = (xs[ok] - float(camera.cx)) / float(camera.fx)
    ry = (ys[ok] - float(camera.cy)) / float(camera.fy)
    pc = np.stack([rx * z, ry * z, z], -1)
    R = camera.R.cpu().numpy()
    t = camera.t.cpu().numpy()
    pw = (pc - t[None]) @ R
    rgb = image_rgb[ok]
    write_ply(path, pw.astype(np.float32), rgb[:, ::-1].astype(np.uint8))
