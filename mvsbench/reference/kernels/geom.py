"""Geometric-consistency (forward-backward reprojection) cost (counterpart
of ``dvpmvs/kernels/geom.py``).

Oracle: ``ComputeGeomConsistencyCost`` (APD.cu:1218-1256): project the ref
pixel at its candidate depth into a source view, look up the source depth
map (nearest, ``(int)(x + 0.5)``), back-project and re-project into the
reference; the cost is the reprojection distance clamped to 3.0 (also 3.0
where the source depth is <= 0 or the distance is not finite).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import fmath
from ..geometry.camera import Camera
from .ncc import _grid

GEOM_MAX = 3.0


@dataclasses.dataclass(frozen=True)
class GeomContext:
    """Per-pass constants for the geometric consistency term."""

    src_depths: torch.Tensor   # [V, H, W] source depth maps (prev pass)
    ref_K: torch.Tensor        # [3, 3]
    ref_R: torch.Tensor
    ref_t: torch.Tensor
    ref_c: torch.Tensor
    src_K: torch.Tensor        # [V, 3, 3]
    src_R: torch.Tensor
    src_t: torch.Tensor
    src_c: torch.Tensor
    rx: torch.Tensor           # [H, W]
    ry: torch.Tensor
    xs: torch.Tensor           # [H, W] pixel x grid
    ys: torch.Tensor
    # [1 + V, 24] the reference, then the source cameras' rows (cam_rows),
    # on the host: the CUDA kernel takes them as a launch argument
    cam_rows: torch.Tensor


def cam_rows(K, R, t, c) -> torch.Tensor:
    """[..., 24] camera constants: K (9), R (9), t (3), c (3)."""
    lead = K.shape[:-2]
    return torch.cat([K.reshape(lead + (9,)), R.reshape(lead + (9,)), t, c],
                     dim=-1).to(torch.float32).contiguous()


def build_geom_context(src_depths: torch.Tensor, ref_cam: Camera,
                       src_cams: Camera) -> GeomContext:
    V, H, W = src_depths.shape
    xs, ys = _grid(H, W, src_depths.device)
    ref_c, src_c = ref_cam.c, src_cams.c
    rows = torch.cat([cam_rows(ref_cam.K, ref_cam.R, ref_cam.t, ref_c)[None],
                      cam_rows(src_cams.K, src_cams.R, src_cams.t, src_c)])
    return GeomContext(
        src_depths=src_depths.to(torch.float32).contiguous(),
        ref_K=ref_cam.K, ref_R=ref_cam.R, ref_t=ref_cam.t, ref_c=ref_c,
        src_K=src_cams.K, src_R=src_cams.R, src_t=src_cams.t,
        src_c=src_c,
        rx=(xs - ref_cam.cx) / ref_cam.fx,
        ry=(ys - ref_cam.cy) / ref_cam.fy,
        xs=xs, ys=ys,
        cam_rows=rows.cpu(),
    )


def _apply33(Mat, x, y, z):
    """Row-wise 3x3 apply, elementwise; Mat [..., 3, 3] broadcasts against
    x, y, z through trailing singleton dims added by the caller."""
    return (Mat[..., 0, 0] * x + Mat[..., 0, 1] * y + Mat[..., 0, 2] * z,
            Mat[..., 1, 0] * x + Mat[..., 1, 1] * y + Mat[..., 1, 2] * z,
            Mat[..., 2, 0] * x + Mat[..., 2, 1] * y + Mat[..., 2, 2] * z)


def _nearest_index(s: torch.Tensor, n: int) -> torch.Tensor:
    """clip((int)(s + 0.5), 0, n - 1), saturating, with NaN -> 0 (the
    conversion XLA and the CUDA kernel make)."""
    v = torch.nan_to_num(torch.clamp(s + 0.5, -1.0, float(n)), nan=0.0)
    return torch.clamp(v.to(torch.int32), 0, n - 1)


def geom_consistency_cost(gctx: GeomContext, depth: torch.Tensor
                          ) -> torch.Tensor:
    """depth [..., H, W] (plane depth at each ref pixel) -> cost
    [..., H, W, V]; views and leading candidates are tensor dims."""
    V, H, W = gctx.src_depths.shape
    lead = depth.dim() - 2

    # ref pixel -> world
    px = depth * gctx.rx
    py = depth * gctx.ry
    pz = depth
    wx, wy, wz = _apply33(gctx.ref_R.T, px, py, pz)
    wx = wx + gctx.ref_c[0]
    wy = wy + gctx.ref_c[1]
    wz = wz + gctx.ref_c[2]

    # per-view constants broadcast as [V, 1.., 1, 1]
    e = lambda a: a.reshape(a.shape[:1] + (1,) * (lead + 2) + a.shape[1:])
    sK, sR, st, sc = (e(gctx.src_K), e(gctx.src_R), e(gctx.src_t),
                      e(gctx.src_c))
    cxx, cyy, czz = _apply33(sR, wx, wy, wz)
    cxx = cxx + st[..., 0]
    cyy = cyy + st[..., 1]
    czz = czz + st[..., 2]
    hx, hy, hz = _apply33(sK, cxx, cyy, czz)
    d_src = torch.where(torch.abs(hz) < 1e-12, torch.full_like(hz, 1e-12), hz)
    sx = hx / d_src
    sy = hy / d_src

    # nearest source-depth lookup ((int)(x + 0.5), APD.cu:1240)
    xi = _nearest_index(sx, W)
    yi = _nearest_index(sy, H)
    flat = (yi.to(torch.int64) * W + xi).reshape(V, -1)
    sd = torch.gather(gctx.src_depths.reshape(V, -1), 1, flat
                      ).reshape(flat.shape[:1] + sx.shape[1:])

    # back-project the SOURCE pixel (float coords, nearest depth)
    bx = sd * (sx - sK[..., 0, 2]) / sK[..., 0, 0]
    by = sd * (sy - sK[..., 1, 2]) / sK[..., 1, 1]
    bz = sd
    wx2, wy2, wz2 = _apply33(sR.transpose(-1, -2), bx, by, bz)
    wx2 = wx2 + sc[..., 0]
    wy2 = wy2 + sc[..., 1]
    wz2 = wz2 + sc[..., 2]

    # re-project into the reference
    rxx, ryy, rzz = _apply33(gctx.ref_R, wx2, wy2, wz2)
    rxx = rxx + gctx.ref_t[0]
    ryy = ryy + gctx.ref_t[1]
    rzz = rzz + gctx.ref_t[2]
    hx2, hy2, hz2 = _apply33(gctx.ref_K, rxx, ryy, rzz)
    hz2 = torch.where(torch.abs(hz2) < 1e-12, torch.full_like(hz2, 1e-12),
                      hz2)
    bxp = hx2 / hz2
    byp = hy2 / hz2

    dist = fmath.sqrt((gctx.xs - bxp) ** 2 + (gctx.ys - byp) ** 2)
    cost = torch.clamp(dist, max=GEOM_MAX)
    invalid = (sd <= 0.0) | ~torch.isfinite(dist)
    cost = torch.where(invalid, torch.full_like(cost, GEOM_MAX), cost)
    return torch.movedim(cost, 0, -1)
