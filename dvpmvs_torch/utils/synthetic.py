"""Synthetic multi-view scenes with exact ground truth.

The reference repo validates only end-to-end on ETH3D/T&T (no tests at all —
SURVEY.md §4).  This generator provides deterministic, photoconsistent scenes
with analytic ground-truth depth for unit/golden tests and benchmarks:

  * geometry: a few slanted world planes (room-corner style) plus an optional
    sphere; per-pixel depth is the nearest positive ray intersection;
  * appearance: a procedural multi-octave 3D texture evaluated at the world
    intersection point, so all views are photoconsistent by construction;
  * a low-texture disc can be stamped in to exercise the weak-pixel machinery.

Everything is numpy (host-side data prep); cameras are float32 CPU tensors.
A copy of ``dvpmvs/utils/synthetic.py``: ``make_scene`` gives the same
arrays bit for bit, and ``write_scene_dir`` the same files byte for byte.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import numpy as np

from ..geometry.camera import Camera
from ..io.camera_io import write_cam_txt, write_pair_txt


@dataclasses.dataclass
class SyntheticScene:
    images: np.ndarray        # [V, H, W] float32 grayscale 0..255
    cameras: List[Camera]     # V single-view cameras
    gt_depth: np.ndarray      # [V, H, W] float32 ground-truth depth
    gt_normal: np.ndarray     # [V, H, W, 3] camera-frame GT normals
    planes_n: np.ndarray      # [P, 3] world plane normals
    planes_d: np.ndarray      # [P] world plane offsets (n.X + d = 0)


def _texture(X: np.ndarray, rng_phases: np.ndarray, amplitude: np.ndarray) -> np.ndarray:
    """Smooth photoconsistent 3D texture in [0, 255]. X [..., 3]."""
    v = np.zeros(X.shape[:-1], np.float64)
    freqs = [1.7, 3.9, 8.1, 16.3, 31.0]
    for k, f in enumerate(freqs):
        ph = rng_phases[k]
        v += (1.0 / (k + 1)) * (
            np.sin(f * X[..., 0] + ph[0])
            * np.sin(f * X[..., 1] + ph[1])
            + 0.7 * np.sin(f * 0.8 * X[..., 2] + ph[2])
        )
    v = v / 4.0
    return np.clip(127.5 + amplitude * 110.0 * v, 0.0, 255.0).astype(np.float32)


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """R, t with z forward toward target (x_cam = R X + t)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ eye
    return R, t


def make_scene(
    num_views: int = 5,
    height: int = 96,
    width: int = 128,
    seed: int = 0,
    weak_disc: bool = False,
    weak_band: bool = False,
    sphere: bool = False,
    noise: float = 0.0,
) -> SyntheticScene:
    """Build a room-corner scene viewed by a small camera arc.

    ``noise`` > 0 applies per-view radiometric perturbation (gain/bias plus
    additive gaussian pixel noise of that sigma, in 0..255 units) — breaks
    the perfect photoconsistency of the procedural texture so accuracy
    claims survive contact with real sensors (round-2 verdict item 7).
    """
    rng = np.random.default_rng(seed)

    # World: three planes forming a shallow corner ~3..5 units away.
    planes_n = np.array(
        [[0.15, 0.1, -1.0],      # back wall, slightly slanted
         [0.0, -1.0, -0.35],     # floor
         [-1.0, 0.05, -0.45]],   # side wall
        np.float64)
    planes_n /= np.linalg.norm(planes_n, axis=1, keepdims=True)
    planes_d = np.array([4.5, 2.2, 3.6], np.float64)   # n.X + d = 0

    fx = fy = 0.9 * width
    K = np.array([[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]],
                 np.float64)

    sphere_c = np.array([0.35, -0.1, 2.6])
    sphere_r = 0.55

    phases = rng.uniform(0, 2 * np.pi, size=(5, 3))

    cams: List[Camera] = []
    images = np.zeros((num_views, height, width), np.float32)
    gt_depth = np.zeros((num_views, height, width), np.float32)
    gt_normal = np.zeros((num_views, height, width, 3), np.float32)

    xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))

    for v in range(num_views):
        ang = (v - (num_views - 1) / 2.0) * 0.12
        eye = np.array([1.4 * np.sin(ang), 0.25 * np.sin(2 * ang),
                        -1.2 * (1 - np.cos(ang))])
        R, t = _look_at(eye, np.array([0.0, 0.0, 3.0]))

        # Camera-frame rays through each pixel.
        ray_cam = np.stack([(xs - K[0, 2]) / K[0, 0],
                            (ys - K[1, 2]) / K[1, 1],
                            np.ones_like(xs)], axis=-1)
        ray_world = ray_cam @ R           # R^T applied row-wise
        origin = eye

        depth = np.full((height, width), np.inf)
        normal_w = np.zeros((height, width, 3))
        for n_pl, d_pl in zip(planes_n, planes_d):
            denom = ray_world @ n_pl
            tt = -(origin @ n_pl + d_pl) / np.where(np.abs(denom) < 1e-9,
                                                    np.nan, denom)
            z = tt * ray_cam[..., 2]      # depth along camera z
            hit = np.isfinite(tt) & (tt > 0.1) & (z < depth)
            depth = np.where(hit, z, depth)
            normal_w = np.where(hit[..., None], n_pl, normal_w)

        if sphere:
            oc = origin - sphere_c
            b = 2.0 * (ray_world @ oc)
            c0 = oc @ oc - sphere_r ** 2
            a = np.sum(ray_world * ray_world, axis=-1)
            disc = b * b - 4 * a * c0
            tt = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
            z = tt * ray_cam[..., 2]
            hit = (disc > 0) & (tt > 0.1) & (z < depth)
            depth = np.where(hit, z, depth)
            Xs = origin + tt[..., None] * ray_world
            sn = Xs - sphere_c
            sn /= np.linalg.norm(sn, axis=-1, keepdims=True) + 1e-12
            normal_w = np.where(hit[..., None], sn, normal_w)

        X = origin + (depth / ray_cam[..., 2])[..., None] * ray_world

        amplitude = np.ones((height, width))
        if weak_disc and v == 0:
            pass  # amplitude modulated in world space below

        amp = np.ones(X.shape[:-1])
        if weak_disc:
            # Low-texture patch painted in world space (view-consistent),
            # centered ON the first plane so it actually intersects geometry.
            n0, d0 = planes_n[0], planes_d[0]
            cx0, cy0 = -0.4, 0.3
            cz0 = -(d0 + n0[0] * cx0 + n0[1] * cy0) / n0[2]
            d2 = np.sum((X - np.array([cx0, cy0, cz0])) ** 2, axis=-1)
            amp = np.where(d2 < 0.8 ** 2, 0.0, 1.0)
        if weak_band:
            # View-consistent textureless horizontal stripe across the
            # scene (world-space y band) — a wide weak structure whose
            # depth only the anchor machinery can recover.
            amp = amp * np.where(np.abs(X[..., 1] - 0.25) < 0.45, 0.0, 1.0)

        img = _texture(X, phases, amp)
        if noise > 0.0:
            gain = 1.0 + rng.normal() * 0.05
            bias = rng.normal() * 2.0 * noise
            img = np.clip(img * gain + bias
                          + rng.normal(size=img.shape) * noise,
                          0.0, 255.0).astype(np.float32)
        images[v] = img
        gt_depth[v] = depth.astype(np.float32)
        # camera-frame normals, oriented toward the camera (n.ray <= 0)
        n_cam = normal_w @ R.T
        flip = np.sum(n_cam * ray_cam, axis=-1) > 0
        n_cam = np.where(flip[..., None], -n_cam, n_cam)
        gt_normal[v] = n_cam.astype(np.float32)

        dmin, dmax = float(np.min(depth)), float(np.max(depth))
        cams.append(Camera.create(K=K, R=R, t=t,
                                  depth_min=dmin * 0.95, depth_max=dmax * 1.05))

    return SyntheticScene(images=images, cameras=cams, gt_depth=gt_depth,
                          gt_normal=gt_normal,
                          planes_n=planes_n.astype(np.float32),
                          planes_d=planes_d.astype(np.float32))


def write_scene_dir(scene: SyntheticScene, folder,
                    with_sfm: bool = False, sfm_points: int = 200) -> Path:
    """Materialize an MVSNet-layout scene directory (npy images).

    ``with_sfm`` also writes ``sfm/%08d.txt`` sparse points (x2d y2d x3d y3d
    z3d r g b, the mono-prior alignment input, APD.cpp:1239-1248) sampled
    from the ground-truth depth."""
    folder = Path(folder)
    (folder / "images").mkdir(parents=True, exist_ok=True)
    (folder / "cams").mkdir(parents=True, exist_ok=True)
    V = scene.images.shape[0]
    pairs = []
    for v in range(V):
        np.save(folder / "images" / f"{v:08d}.npy", scene.images[v])
        write_cam_txt(folder / "cams" / f"{v:08d}_cam.txt", scene.cameras[v])
        srcs = [(u, 100.0) for u in range(V) if u != v]
        pairs.append((v, srcs))
    write_pair_txt(folder / "pair.txt", pairs)
    if with_sfm:
        (folder / "sfm").mkdir(exist_ok=True)
        rng = np.random.default_rng(0)
        H, W = scene.images.shape[1:3]
        for v in range(V):
            cam = scene.cameras[v]
            xs = rng.integers(2, W - 2, sfm_points)
            ys = rng.integers(2, H - 2, sfm_points)
            z = scene.gt_depth[v, ys, xs]
            rx = (xs - float(cam.cx)) / float(cam.fx)
            ry = (ys - float(cam.cy)) / float(cam.fy)
            pc = np.stack([rx * z, ry * z, z], -1)          # camera frame
            R = cam.R.cpu().numpy()
            t = cam.t.cpu().numpy()
            pw = (pc - t[None]) @ R                          # world frame
            col = np.repeat(
                scene.images[v, ys, xs, None], 3, axis=-1)
            rows = np.concatenate(
                [np.stack([xs, ys], -1).astype(np.float64), pw, col], -1)
            np.savetxt(folder / "sfm" / f"{v:08d}.txt", rows, fmt="%.6f")
    return folder
