"""Plane-hypothesis refinement candidates (counterpart of
``dvpmvs/kernels/refine.py``; oracle ``PlaneHypothesisRefinementStrong``,
APD.cu:1311-1383): six candidate planes per pixel from
{random depth, current depth, perturbed depth} x
{current normal, random visibility-prior normal, perturbed normal}:

    depths  = [d_rand, d_cur,  d_rand, d_cur,   d_cur,   d_pert]
    normals = [n_cur,  n_rand, n_rand, n_pert1, n_pert2, n_cur ]
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..geometry.camera import Camera
from ..rng import DrawSource, KeyPath, split
from .sampling import (Packer, identity_pack, perturbed_normal,
                       plane_from_normal_depth, random_depth,
                       visibility_prior_normal)

DEPTH_PERTURBATION = 0.02
NORMAL_PERTURBATION = 0.02 * math.pi


def refinement_planes(
    draws: DrawSource, path: KeyPath,
    cur_normal: torch.Tensor,   # [H', W', 3] (ref frame)
    cur_depth: torch.Tensor,    # [H', W']
    sel_views: torch.Tensor,    # [H', W', V] bool
    rx, ry, xs, ys,
    ref_cam: Camera, src_cams: Camera,
    depth_min, depth_max,
    full_hw: Optional[Tuple[int, int]] = None,
    pk: Packer = identity_pack,
) -> torch.Tensor:
    """The 6 refinement candidate planes -> [6, H', W', 4]."""
    full_hw = tuple(cur_depth.shape) if full_hw is None else tuple(full_hw)
    p_rand_d, p_rand_n, p_pert1, p_pert2, p_pert_d = (
        split(path, 5, i) for i in range(5))

    d_rand = pk(random_depth(draws, p_rand_d, full_hw, depth_min, depth_max),
                0)
    n_rand = visibility_prior_normal(draws, p_rand_n, cur_depth, sel_views,
                                     rx, ry, ref_cam, src_cams,
                                     full_hw=full_hw, pk=pk)
    n_pert1 = perturbed_normal(draws, p_pert1, cur_normal, rx, ry,
                               NORMAL_PERTURBATION, full_hw=full_hw, pk=pk)
    n_pert2 = perturbed_normal(draws, p_pert2, cur_normal, rx, ry,
                               NORMAL_PERTURBATION, full_hw=full_hw, pk=pk)
    d_pert = cur_depth * pk(draws.uniform(
        p_pert_d, full_hw, 1.0 - DEPTH_PERTURBATION,
        1.0 + DEPTH_PERTURBATION), 0)

    combos = [
        (d_rand, cur_normal),
        (cur_depth, n_rand),
        (d_rand, n_rand),
        (cur_depth, n_pert1),
        (cur_depth, n_pert2),
        (d_pert, cur_normal),
    ]
    return torch.stack([plane_from_normal_depth(n, d, xs, ys, ref_cam)
                        for d, n in combos])
