"""Projective geometry on tensors (counterpart of
``dvpmvs/geometry/transforms.py``; formulas mirror the reference device
helpers, APD.cu:386-739).

A plane hypothesis is (nx, ny, nz, w): unit normal in the reference camera
frame plus the plane's signed distance to the camera origin (w = -n . X_cam).
The persistence form swaps in the world normal and the per-pixel depth.
All functions broadcast over leading pixel dims; intrinsics are skew-free.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import fmath
from ..rng import DrawSource, KeyPath, split
from .camera import Camera


def view_ray(x, y, cam: Camera, normalize: bool = True) -> torch.Tensor:
    """Camera-frame ray through pixel (x, y): ((x-cx)/fx, (y-cy)/fy, 1)."""
    rx = (x - cam.cx) / cam.fx
    ry = (y - cam.cy) / cam.fy
    ray = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    if normalize:
        ray = ray / fmath.norm(ray, dim=-1, keepdim=True)
    return ray


def depth_from_plane(plane: torch.Tensor, x, y, cam: Camera) -> torch.Tensor:
    """Depth of the plane (n, w) along the ray of pixel (x, y):
    depth = -w / (n . u) with u the unnormalized ray."""
    n = plane[..., :3]
    w = plane[..., 3]
    rx = (x - cam.cx) / cam.fx
    ry = (y - cam.cy) / cam.fy
    denom = n[..., 0] * rx + n[..., 1] * ry + n[..., 2]
    return -w / denom


def dist_to_origin(normal: torch.Tensor, x, y, depth, cam: Camera
                   ) -> torch.Tensor:
    """Signed plane distance w = -(n . X_cam) for X_cam = depth * u."""
    rx = (x - cam.cx) / cam.fx
    ry = (y - cam.cy) / cam.fy
    ndotu = normal[..., 0] * rx + normal[..., 1] * ry + normal[..., 2]
    return -depth * ndotu


def backproject_cam(x, y, depth, cam: Camera) -> torch.Tensor:
    """Pixel + depth -> camera-frame 3D point ([..., 3])."""
    px = depth * (x - cam.cx) / cam.fx
    py = depth * (y - cam.cy) / cam.fy
    return torch.stack([px, py, depth], dim=-1)


def cam_to_world(X_cam: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Camera-frame point -> world: X = R^T X_cam + c."""
    return fmath.rmatvec(cam.R, X_cam) + cam.c


def world_to_cam_point(X_world: torch.Tensor, cam: Camera) -> torch.Tensor:
    return fmath.matvec(cam.R, X_world) + cam.t


def project(X_world: torch.Tensor, cam: Camera
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World point -> (pixel xy [..., 2], depth)."""
    xc = world_to_cam_point(X_world, cam)
    h = fmath.matvec(cam.K, xc)
    depth = h[..., 2]
    return h[..., :2] / depth[..., None], depth


def plane_to_world(plane: torch.Tensor, x, y, ref: Camera) -> torch.Tensor:
    """(n_ref, w) -> (n_world, depth) persistence form."""
    n_world = fmath.rmatvec(ref.R, plane[..., :3])
    depth = depth_from_plane(plane, x, y, ref)
    return torch.cat([n_world, depth[..., None]], dim=-1)


def plane_from_world(world_plane: torch.Tensor, x, y, ref: Camera
                     ) -> torch.Tensor:
    """(n_world, depth) -> (n_ref, w) compute form."""
    n_ref = fmath.matvec(ref.R, world_plane[..., :3])
    w = dist_to_origin(n_ref, x, y, world_plane[..., 3], ref)
    return torch.cat([n_ref, w[..., None]], dim=-1)


def relative_pose(ref: Camera, src: Camera
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R_rel = R_src R_ref^T,  t_rel = R_src (C_ref - C_src)."""
    R_rel = fmath.matmul_bt(src.R, ref.R)
    t_rel = fmath.matvec(src.R, ref.c - src.c)
    return R_rel, t_rel


def homography_terms(ref: Camera, src: Camera
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-view constants of the plane-induced homography:
    H u = M u - b (n . u)/w with M = K_src R_rel, b = K_src t_rel."""
    R_rel, t_rel = relative_pose(ref, src)
    M = fmath.matmul(src.K, R_rel)
    b = fmath.matvec(src.K, t_rel)
    return M, b


def warp_terms(plane: torch.Tensor, x, y, cam: Camera):
    """Per-pixel pieces of the homography warp: (u, s, sx, sy) with
    u = K^-1 [x, y, 1], s = (n . u)/w, sx = nx/(fx w), sy = ny/(fy w)."""
    n = plane[..., :3]
    w = plane[..., 3]
    rx = (x - cam.cx) / cam.fx
    ry = (y - cam.cy) / cam.fy
    u = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    s = (n[..., 0] * rx + n[..., 1] * ry + n[..., 2]) / w
    sx = n[..., 0] / (cam.fx * w)
    sy = n[..., 1] / (cam.fy * w)
    return u, s, sx, sy


def random_unit_normals(draws: DrawSource, path: KeyPath, shape
                        ) -> torch.Tensor:
    """Uniform unit normals via the spherical construction -> [*shape, 3]:
    z ~ U(-1, 1), phi ~ U(0, 2pi), n = (r cos phi, r sin phi, z)."""
    z = draws.uniform(split(path, 2, 0), shape, -1.0, 1.0)
    phi = draws.uniform(split(path, 2, 1), shape, 0.0, 2.0 * math.pi)
    r = fmath.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * fmath.cos(phi), r * fmath.sin(phi), z], dim=-1)
