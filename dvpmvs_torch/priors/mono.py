"""Monocular-depth prior bootstrap for FIRST_INIT (counterpart of
``dvpmvs/priors/mono.py``).

Oracle: the mono-depth block of ``APD::InuputInitialization``
(APD.cpp:1210-1424):
  * the Depth-Anything map arrives inverted: depth = 255 - value;
  * per sparse SfM point: ratio = mono_depth(projection) / projected_depth;
  * the ratio field is the median everywhere, replaced inside the Delaunay
    triangulation of the sparse points by barycentric interpolation
    (scipy's LinearNDInterpolator IS Delaunay-based, the same semantics);
  * depth = mono / ratio;  normals from 3D cross products of neighboring
    camera-frame points, flipped toward the camera, rotated to world frame.

Host-side numpy/scipy; runs once per view before the schedule.  The
functions take the port's ``Camera`` and read it through numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.interpolate import LinearNDInterpolator
from scipy.spatial import QhullError

from ..geometry.camera import Camera
from .edges import _resize_linear


def _f64(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def align_mono_depth(
    mono: np.ndarray,            # [H, W] raw mono map (will be inverted)
    sparse_xy: np.ndarray,       # [N, 2] image points
    sparse_xyz: np.ndarray,      # [N, 3] world points
    cam: Camera,
    invert: bool = True,
) -> np.ndarray:
    """Scale-align a relative mono-depth map with sparse SfM points."""
    H, W = mono.shape
    dep = (255.0 - mono) if invert else mono.astype(np.float64)
    K, R, t = _f64(cam.K), _f64(cam.R), _f64(cam.t)

    xc = sparse_xyz @ R.T + t
    proj_depth = xc[:, 2]
    px = xc[:, 0] / proj_depth * K[0, 0] + K[0, 2] * 1.0
    py = xc[:, 1] / proj_depth * K[1, 1] + K[1, 2] * 1.0
    xi = np.round(px).astype(int)
    yi = np.round(py).astype(int)
    ok = (xi > 0) & (xi < W) & (yi > 0) & (yi < H) & (proj_depth > 0)
    if ok.sum() < 4:
        return dep.astype(np.float32)

    rates = dep[yi[ok], xi[ok]] / proj_depth[ok]
    pts = np.stack([px[ok], py[ok]], axis=-1)

    # APD.cpp:1276: middle_rate = rates[size/2] (insertion order, not sorted);
    # a true median is the obvious intent
    middle = float(np.median(rates))
    rate_map = np.full((H, W), middle)
    try:
        interp = LinearNDInterpolator(pts, rates)
    except QhullError:
        # degenerate points (e.g. collinear): no triangulation, the median
        interp = None
    if interp is not None:
        ys, xs = np.mgrid[0:H, 0:W]
        vals = interp(np.stack([xs.ravel(), ys.ravel()], -1)).reshape(H, W)
        rate_map = np.where(np.isfinite(vals), vals, middle)

    rate_map = np.where(np.abs(rate_map) < 1e-9, middle, rate_map)
    return (dep / rate_map).astype(np.float32)


def normals_from_depth(depth: np.ndarray, cam: Camera,
                       to_world: bool = True) -> np.ndarray:
    """Per-pixel normals from cross products of camera-frame points
    (APD.cpp:1368-1409): n = normalize(dP/dx x dP/dy), flipped toward the
    camera, optionally rotated into the world frame."""
    H, W = depth.shape
    K = _f64(cam.K)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    X = np.stack([depth * (xs - K[0, 2]) / K[0, 0],
                  depth * (ys - K[1, 2]) / K[1, 1],
                  depth.astype(np.float64)], axis=-1)
    dx = np.zeros_like(X)
    dy = np.zeros_like(X)
    dx[:, :-1] = X[:, 1:] - X[:, :-1]
    dx[:, -1] = dx[:, -2]
    dy[:-1, :] = X[1:, :] - X[:-1, :]
    dy[-1, :] = dy[-2, :]
    n = np.cross(dx, dy)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    view = X / np.maximum(np.linalg.norm(X, axis=-1, keepdims=True), 1e-12)
    flip = np.sum(n * view, axis=-1) > 0
    n = np.where(flip[..., None], -n, n)
    if to_world:
        n = n @ _f64(cam.R)     # row-vector x R == R^T n
    return n.astype(np.float32)


def mono_prior_planes(
    mono: np.ndarray,
    sparse_xy: np.ndarray,
    sparse_xyz: np.ndarray,
    cam: Camera,
    target_hw: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Full FIRST_INIT bootstrap -> persistence-form planes [H, W, 4]
    (world normal, depth), the engine's ``init_plane_world`` input."""
    depth = align_mono_depth(mono, sparse_xy, sparse_xyz, cam)
    if target_hw is not None and depth.shape != tuple(target_hw):
        depth = _resize_linear(depth, target_hw)
    normals = normals_from_depth(depth, cam, to_world=True)
    return np.concatenate([normals, depth[..., None]], axis=-1)


def read_sfm_txt(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse sfm/%08d.txt: rows of `x2d y2d x3d y3d z3d r g b`
    (APD.cpp:1239-1248)."""
    rows = np.loadtxt(path, ndmin=2)
    if rows.size == 0:
        return (np.zeros((0, 2)), np.zeros((0, 3)), np.zeros((0, 3)))
    return rows[:, 0:2], rows[:, 2:5], rows[:, 5:8]
