"""Hypothesis sampling: visibility-prior random normals, perturbations,
random depths (counterpart of ``dvpmvs/kernels/sampling.py``; oracles
``GenerateRandomNormal_YZL``, ``GeneratePerturbedNormal`` and
``GenerateRandomPlaneHypothesis_YZL``, APD.cu:501-670).

Every draw goes through the draw source (``rng.py``) at the full image grid
``full_hw`` and is then packed by ``pk(arr, axis)`` (the checkerboard packing
of the caller's evaluation grid, or the identity), so the packed and the
full-grid paths consume the same numbers at every pixel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..geometry.camera import Camera
from ..geometry.transforms import dist_to_origin, random_unit_normals
from ..rng import DrawSource, KeyPath
from .gatherfree import take0

Packer = Callable[[torch.Tensor, int], torch.Tensor]


def identity_pack(arr: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return arr


def _normalize(v, dim=-1):
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True),
                           min=1e-12)


def view_direction_set(depth, sel_views, rx, ry, ref_cam: Camera,
                       src_cams: Camera):
    """Per-pixel direction set for the visibility prior.

    Returns (dirs [V+1, 3, H, W], active [V+1, H, W]): slot 0 is the ref
    ray, slots 1..V the selected source-view rays in the ref frame."""
    ones = torch.ones_like(rx)

    def norm3(x, y, z):
        inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-24))
        return torch.stack([x * inv, y * inv, z * inv])

    ray_ref = norm3(rx, ry, ones)
    Xc = torch.stack([depth * rx, depth * ry, depth])
    Rr = ref_cam.R
    c = ref_cam.c
    Xw = torch.stack([Rr[0, i] * Xc[0] + Rr[1, i] * Xc[1] + Rr[2, i] * Xc[2]
                      + c[i] for i in range(3)])

    e = lambda a: a[:, None, None]
    K, R, t = src_cams.K, src_cams.R, src_cams.t
    xc = [e(R[:, i, 0]) * Xw[0] + e(R[:, i, 1]) * Xw[1]
          + e(R[:, i, 2]) * Xw[2] + e(t[:, i]) for i in range(3)]
    h = [e(K[:, i, 0]) * xc[0] + e(K[:, i, 1]) * xc[1] + e(K[:, i, 2]) * xc[2]
         for i in range(3)]
    z = torch.where(torch.abs(h[2]) < 1e-12, torch.full_like(h[2], 1e-12),
                    h[2])
    sxi = torch.floor(h[0] / z + 0.5)
    syi = torch.floor(h[1] / z + 0.5)
    srx = (sxi - e(K[:, 0, 2])) / e(K[:, 0, 0])
    sry = (syi - e(K[:, 1, 2])) / e(K[:, 1, 1])
    ray_src = norm3(srx, sry, torch.ones_like(srx))          # [3, V, H, W]
    Rc = torch.einsum("ij,vkj->vik", ref_cam.R, R)           # R_ref R_src^T
    src_dirs = torch.stack(
        [e(Rc[:, i, 0]) * ray_src[0] + e(Rc[:, i, 1]) * ray_src[1]
         + e(Rc[:, i, 2]) * ray_src[2] for i in range(3)], dim=1)
    dirs = torch.cat([ray_ref[None], src_dirs])              # [V+1, 3, H, W]
    active = torch.cat([torch.ones_like(depth, dtype=torch.bool)[None],
                        torch.movedim(sel_views, -1, 0)])
    return dirs, active


def visibility_prior_normal(draws: DrawSource, path: KeyPath, depth,
                            sel_views, rx, ry, ref_cam: Camera,
                            src_cams: Camera, samples: int = 8,
                            full_hw: Optional[Tuple[int, int]] = None,
                            pk: Packer = identity_pack) -> torch.Tensor:
    """Per-pixel unit normals facing away from all active view rays."""
    full_hw = tuple(depth.shape) if full_hw is None else tuple(full_hw)
    dirs, active = view_direction_set(depth, sel_views, rx, ry, ref_cam,
                                      src_cams)
    cand = pk(random_unit_normals(draws, path, (samples,) + full_hw), 1)
    cand_c = torch.movedim(cand, -1, 1)                     # [S, 3, H, W]
    ok = torch.ones((samples,) + tuple(depth.shape), dtype=torch.bool,
                    device=depth.device)
    for v in range(dirs.shape[0]):
        dot = (cand_c[:, 0] * dirs[v, 0] + cand_c[:, 1] * dirs[v, 1]
               + cand_c[:, 2] * dirs[v, 2])
        ok = ok & ((dot <= 0.0) | ~active[v])
    first = torch.argmax(ok.to(torch.uint8), dim=0)         # first True
    any_ok = torch.any(ok, dim=0)
    picked = take0(cand, first)
    ray_ref = torch.movedim(dirs[0], 0, -1)
    flip = torch.where(torch.sum(cand[0] * ray_ref, -1, keepdim=True) > 0,
                       -cand[0], cand[0])
    return torch.where(any_ok[..., None], picked, flip)


def perturbed_normal(draws: DrawSource, path: KeyPath, normal, rx, ry,
                     perturbation: float,
                     full_hw: Optional[Tuple[int, int]] = None,
                     pk: Packer = identity_pack) -> torch.Tensor:
    """Small random rotation of the normal; keeps the original where the
    rotated one would face the camera (quirk Q3 fixed, as in dvpmvs)."""
    full_hw = tuple(normal.shape[:2]) if full_hw is None else tuple(full_hw)
    ang = pk(draws.uniform(path, (3,) + full_hw, -perturbation,
                           perturbation), 1)
    a1, a2, a3 = ang[0], ang[1], ang[2]
    s1, c1 = torch.sin(a1), torch.cos(a1)
    s2, c2 = torch.sin(a2), torch.cos(a2)
    s3, c3 = torch.sin(a3), torch.cos(a3)
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    px = (c1 * c2) * nx + (c1 * s2 * s3 - s1 * c3) * ny \
        + (c1 * s2 * c3 + s1 * s3) * nz
    py = (s1 * c2) * nx + (s1 * s2 * s3 + c1 * c3) * ny \
        + (s1 * s2 * c3 - c1 * s3) * nz
    pz = (-s2) * nx + (c2 * s3) * ny + (c2 * c3) * nz
    p = _normalize(torch.stack([px, py, pz], dim=-1))
    ray = _normalize(torch.stack([rx, ry, torch.ones_like(rx)], dim=-1))
    faces_camera = torch.sum(p * ray, dim=-1, keepdim=True) > 0
    return torch.where(faces_camera, normal, p)


def random_depth(draws: DrawSource, path: KeyPath, shape, depth_min,
                 depth_max) -> torch.Tensor:
    return draws.uniform(path, shape, 0.0, 1.0) * (depth_max - depth_min) \
        + depth_min


def plane_from_normal_depth(normal, depth, xs, ys, ref_cam: Camera):
    """(n, depth at pixel) -> (n, w) plane hypothesis field."""
    w = dist_to_origin(normal, xs, ys, depth, ref_cam)
    return torch.cat([normal, w[..., None]], dim=-1)
