"""Batched bilateral-NCC matching cost (counterpart of
``dvpmvs/kernels/ncc.py``).

Behavioral oracle: ``ComputeBilateralNCCOld`` (APD.cu:1023-1113) — windowed
bilateral-weighted NCC between the reference patch and its homography-warped
source patch; cost = clamp(1 - NCC, 0, 2), 2 on degenerate variance or a
center projecting outside the source view.

Plane-independent quantities (bilateral weights, reference-side moments,
per-view homography constants) are computed once per pass into a
``CostContext``.  The 6x6 tap grid is r * {+-0.2, +-0.6, +-1.0}^2 with r the
static strong radius or the per-pixel adaptive radius.

Backends: ``"exact"`` evaluates each plane here in plain PyTorch (taps and
views are tensor dimensions); ``"fused"`` sends every batch to the NCC
kernel (``ncc_fused.py``), which evaluates the same function; ``"warp"``
warps the sources once per plane and reads the warped field at the 36
taps' static integer shifts, all B planes in one launch of the kernel of
``warp_fused.warp_ncc``: the tap at p + d then sees the homography of the
plane at p + d, not at p, which agrees with the exact window where the
plane field is locally constant.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import fmath
from ..geometry.camera import Camera
from ..geometry.transforms import homography_terms

COST_MAX = 2.0
_K_MIN_VAR = 1e-5

# Normalized 6-point tap axis: radius * these = the reference window
# (-r, -3r/5, -r/5, r/5, 3r/5, r) (defaults r=5 -> -5,-3,-1,1,3,5).
_TAP_AXIS = np.array([-1.0, -0.6, -0.2, 0.2, 0.6, 1.0], np.float32)


def tap_grid() -> np.ndarray:
    """[T, 2] normalized (gx, gy) tap offsets, T = 36 (gx fastest)."""
    gx, gy = np.meshgrid(_TAP_AXIS, _TAP_AXIS)
    return np.stack([gx.ravel(), gy.ravel()], axis=-1)


def _grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xs, ys) float32 pixel grids [H, W]."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=device),
                            torch.arange(W, dtype=torch.float32,
                                         device=device), indexing="ij")
    return xs, ys


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    """Bilinear sample of img [H, W] at float coords (border-clamped)."""
    return _bilinear_sample_batch(img[None], x[None], y[None])[0]


def _bilinear_sample_batch(imgs: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """imgs [V, H, W]; x, y [V, ...] per-view float coords -> [V, ...]."""
    V, H, W = imgs.shape
    shape = x.shape
    x = torch.clamp(x, 0.0, W - 1.0).reshape(V, -1)
    y = torch.clamp(y, 0.0, H - 1.0).reshape(V, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    # a NaN coordinate (degenerate plane) keeps a NaN value, as in JAX; its
    # index is pinned to 0 so the gather stays in bounds
    x0i = torch.nan_to_num(x0, nan=0.0).to(torch.int64)
    y0i = torch.nan_to_num(y0, nan=0.0).to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = imgs.reshape(V, -1)
    i00 = torch.gather(flat, 1, y0i * W + x0i)
    i01 = torch.gather(flat, 1, y0i * W + x1i)
    i10 = torch.gather(flat, 1, y1i * W + x0i)
    i11 = torch.gather(flat, 1, y1i * W + x1i)
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return (top * (1 - fy) + bot * fy).reshape(shape)


def shift2(arr: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[..., y, x] = arr[..., y+dy, x+dx] (wrap; callers mask borders)."""
    return torch.roll(arr, shifts=(-dy, -dx), dims=(-2, -1))


@dataclasses.dataclass(frozen=True)
class CostContext:
    """Plane-independent, per-pass precomputation for the NCC cost."""

    src_imgs: torch.Tensor     # [V, H, W] fp32 sources
    rx: torch.Tensor           # [H, W]   (x - cx) / fx
    ry: torch.Tensor           # [H, W]
    M: torch.Tensor            # [V, 3, 3]  K_src R_rel
    b: torch.Tensor            # [V, 3]     K_src t_rel
    cam: torch.Tensor          # [4] reference cx, cy, fx, fy
    radius: torch.Tensor       # [H, W] per-pixel window radius
    w_taps: torch.Tensor       # [T, H, W] bilateral weights
    wref_taps: torch.Tensor    # [T, H, W] weight * ref intensity
    sum_w: torch.Tensor        # [H, W]
    sum_wref: torch.Tensor     # [H, W]
    sum_wref2: torch.Tensor    # [H, W]
    src_wh: torch.Tensor       # [V, 2] source view (width, height) bounds
    backend: str = "exact"
    strong_radius: int = 5
    has_radius_map: bool = False
    color_only: bool = False
    # the image row of the per-pixel fields' first row: a row window of the
    # tiled pass holds the fields of its compute rows only
    y0: int = 0

    @property
    def num_views(self) -> int:
        return self.src_imgs.shape[0]

    @property
    def shape(self):
        return tuple(self.src_imgs.shape[1:])

    @property
    def inv_fx(self) -> torch.Tensor:
        return 1.0 / self.cam[2]

    @property
    def inv_fy(self) -> torch.Tensor:
        return 1.0 / self.cam[3]

    def replace(self, **kw) -> "CostContext":
        return dataclasses.replace(self, **kw)


def build_cost_context(
    ref_img: torch.Tensor,
    src_imgs: torch.Tensor,
    ref_cam: Camera,
    src_cams: Camera,
    sigma_spatial,
    sigma_color,
    radius_map: Optional[torch.Tensor] = None,
    strong_radius: int = 5,
    src_wh: Optional[torch.Tensor] = None,
    backend: str = "exact",
    color_only_weights: bool = False,
    rows=None,
) -> CostContext:
    """Precompute everything the candidate loop reuses.

    ``src_cams`` carries a leading [V] axis.  ``radius_map`` ([H, W]) enables
    the adaptive window; zeros fall back to ``strong_radius``.  With
    ``rows`` (an ``engine.rows.RowWindow``) the per-pixel fields are those
    of its compute rows, read from the whole reference image.
    """
    H, W = ref_img.shape
    dev = ref_img.device
    xs, ys = _grid(H, W, dev)
    ref_c, row_ids, y0 = ref_img, torch.arange(H, device=dev), 0
    if rows is not None:
        xs, ys, ref_c = rows.take(xs), rows.take(ys), rows.take(ref_img)
        row_ids, y0 = rows.row_ids(dev), rows.c0
        if radius_map is not None:
            radius_map = rows.take(radius_map)
    Hc = xs.shape[0]
    rx = (xs - ref_cam.cx) / ref_cam.fx
    ry = (ys - ref_cam.cy) / ref_cam.fy
    M, b = homography_terms(ref_cam, src_cams)

    if radius_map is None:
        radius = torch.full((Hc, W), float(strong_radius), device=dev)
    else:
        r = radius_map.to(torch.float32)
        radius = torch.where(r <= 0, torch.full_like(r, float(strong_radius)),
                             r)

    taps = torch.as_tensor(tap_grid(), device=dev)       # [T, 2]
    gx = taps[:, 0, None, None]
    gy = taps[:, 1, None, None]
    sigma_spatial = torch.as_tensor(sigma_spatial, dtype=torch.float32,
                                    device=dev)
    sigma_color = torch.as_tensor(sigma_color, dtype=torch.float32,
                                  device=dev)

    static_radius = radius_map is None
    static_int = static_radius and all(
        float(t * strong_radius).is_integer() for t in _TAP_AXIS)
    if static_int:
        # integer static offsets: an edge-clamped shifted copy per tap
        offs = np.round(tap_grid() * strong_radius).astype(np.int64)
        iy = torch.clamp(row_ids[None, :, None]
                         + torch.as_tensor(offs[:, 1], device=dev)[:, None,
                                                                   None],
                         0, H - 1)
        ix = torch.clamp(torch.arange(W, device=dev)[None, None, :]
                         + torch.as_tensor(offs[:, 0], device=dev)[:, None,
                                                                   None],
                         0, W - 1)
        ref_t = ref_img[iy, ix]                                 # [T, H, W]
        spatial = torch.as_tensor(
            np.hypot(offs[:, 0], offs[:, 1]).astype(np.float32),
            device=dev)[:, None, None]
    elif static_radius:
        dx = gx * float(strong_radius)
        dy = gy * float(strong_radius)
        ref_t = bilinear_sample(ref_img, (xs + dx), (ys + dy))
        offs = tap_grid().astype(np.float64) * float(strong_radius)
        spatial = torch.as_tensor(
            np.hypot(offs[:, 0], offs[:, 1]).astype(np.float32),
            device=dev)[:, None, None]
    else:
        dx = gx * radius
        dy = gy * radius
        ref_t = _bilinear_sample_batch(ref_img[None], (xs + dx)[None],
                                       (ys + dy)[None])[0]
        spatial = fmath.hypot(dx, dy)
    # reference weight: exp(-dist/(2 s_sp^2) - |dI|/(2 s_c^2)), with the
    # NON-squared distances of APD.cu:776-781; the weak-pixel cost drops the
    # spatial term (ComputeBilateralWeight_YZL, APD.cu:783-788)
    if color_only_weights:
        w_taps = fmath.exp(-torch.abs(ref_t - ref_c)
                           / (2.0 * sigma_color * sigma_color))
    else:
        w_taps = fmath.exp(-spatial / (2.0 * sigma_spatial * sigma_spatial)
                           - torch.abs(ref_t - ref_c)
                           / (2.0 * sigma_color * sigma_color))
    wref_taps = w_taps * ref_t
    # tap-ordered sums, as the reference loop accumulates them
    sum_w, sum_wref, sum_wref2 = w_taps[0], wref_taps[0], wref_taps[0] * ref_t[0]
    for t in range(1, w_taps.shape[0]):
        sum_w = sum_w + w_taps[t]
        sum_wref = sum_wref + wref_taps[t]
        sum_wref2 = sum_wref2 + wref_taps[t] * ref_t[t]

    V = src_imgs.shape[0]
    if src_wh is None:
        src_wh = torch.tensor([[W, H]], dtype=torch.float32,
                              device=dev).repeat(V, 1)
    cam = torch.stack([ref_cam.cx, ref_cam.cy, ref_cam.fx, ref_cam.fy])

    return CostContext(
        src_imgs=src_imgs.to(torch.float32).contiguous(), rx=rx, ry=ry,
        M=M, b=b, cam=cam.to(torch.float32),
        radius=radius, w_taps=w_taps, wref_taps=wref_taps,
        sum_w=sum_w, sum_wref=sum_wref, sum_wref2=sum_wref2,
        src_wh=torch.as_tensor(src_wh, dtype=torch.float32, device=dev),
        backend=backend, strong_radius=strong_radius,
        has_radius_map=radius_map is not None,
        color_only=color_only_weights, y0=y0,
    )


def plane_warp_fields(M, b, plane, rx, ry, inv_fx, inv_fy):
    """Per-(view, pixel) homography pieces of a plane field: H u = base +
    i colx + j coly.  plane [*P, 4] (n, w); rx, ry [*P] -> three triples of
    [V, *P] fields."""
    n = plane[..., :3]
    w_d = plane[..., 3]
    s = (n[..., 0] * rx + n[..., 1] * ry + n[..., 2]) / w_d
    sx = n[..., 0] * inv_fx / w_d
    sy = n[..., 1] * inv_fy / w_d
    return _homography_fields(M, b, rx, ry, s, sx, sy, inv_fx, inv_fy)


def _warp_terms(ctx: CostContext, plane: torch.Tensor):
    """plane [H, W, 4] -> homography pieces, three triples of [V, H, W]."""
    return plane_warp_fields(ctx.M, ctx.b, plane, ctx.rx, ctx.ry,
                             ctx.inv_fx, ctx.inv_fy)


def _homography_fields(M, b, rx, ry, s, sx, sy, inv_fx, inv_fy):
    """M [V, 3, 3], b [V, 3]; rx, ry, s, sx, sy [*P] -> base, colx, coly,
    each a triple of [V, *P] fields (H u = base + i colx + j coly)."""
    nd = rx.dim()
    e = lambda a: a.reshape(a.shape + (1,) * nd)         # [V] -> [V, 1..]
    colx = tuple(e(M[:, i, 0]) * inv_fx - e(b[:, i]) * sx for i in range(3))
    coly = tuple(e(M[:, i, 1]) * inv_fy - e(b[:, i]) * sy for i in range(3))
    return _base_fields(M, b, rx, ry, s), colx, coly


def _base_fields(M, b, rx, ry, s):
    """The homography of the ray (rx, ry) under the plane term s: M [V, 3, 3],
    b [V, 3]; rx, ry, s [*P] -> the base triple of [V, *P] fields."""
    nd = rx.dim()
    e = lambda a: a.reshape(a.shape + (1,) * nd)         # [V] -> [V, 1..]
    return tuple((e(M[:, i, 0]) * rx + e(M[:, i, 1]) * ry + e(M[:, i, 2]))
                 - e(b[:, i]) * s for i in range(3))


def _guard(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def _center_coords(base, src_wh: torch.Tensor):
    """The window center's source pixel and in-view test: base triple
    [V, *P] -> (x, y, in_view), each [V, *P]."""
    base0, base1, base2 = base
    cz = _guard(base2)
    cx_pix = base0 / cz
    cy_pix = base1 / cz
    nd = base0.dim() - 1
    sw = src_wh[:, 0].reshape((-1,) + (1,) * nd)
    sh = src_wh[:, 1].reshape((-1,) + (1,) * nd)
    return cx_pix, cy_pix, ((cx_pix >= 0) & (cx_pix < sw) & (cy_pix >= 0)
                            & (cy_pix < sh) & (base2 > 0))


def _center_inview(base, src_wh: torch.Tensor) -> torch.Tensor:
    """In-view test of the window center: base triple [V, *P] -> bool."""
    return _center_coords(base, src_wh)[2]


def _window_moments(src_imgs, base, colx, coly, radius, w_taps, wref_taps):
    """Source-side moments of the 36-tap window, taps and views as tensor
    dims.  base/colx/coly triples [V, *P]; radius scalar or [*P];
    w_taps/wref_taps [T, *P] -> (sum w*src, sum w*src^2, sum wref*src),
    each [V, *P]."""
    P = base[0].shape[1:]
    taps = torch.as_tensor(tap_grid(), device=src_imgs.device)
    nd = len(P)
    gx = taps[:, 0].reshape((-1,) + (1,) * nd)              # [T, 1..]
    gy = taps[:, 1].reshape((-1,) + (1,) * nd)
    di = (gx * radius)[None]                                 # [1, T, *P]
    dj = (gy * radius)[None]
    u = lambda a: a[:, None]                                 # [V, 1, *P]
    hx = u(base[0]) + di * u(colx[0]) + dj * u(coly[0])
    hy = u(base[1]) + di * u(colx[1]) + dj * u(coly[1])
    hz = _guard(u(base[2]) + di * u(colx[2]) + dj * u(coly[2]))
    src_t = _bilinear_sample_batch(src_imgs, hx / hz, hy / hz)  # [V, T, *P]
    return tap_moments(src_t, w_taps, wref_taps)


def tap_moments(src_t, w_taps, wref_taps):
    """(sum w*src, sum w*src^2, sum wref*src) over the tap axis 1 of
    src_t [V, T, *P], accumulated tap by tap in tap order: the same order
    as the reference loop and the CUDA kernels, so the ill-conditioned
    variance (m2 - m^2 at intensities ~128) rounds the same way in all."""
    s1 = s2 = s3 = 0.0
    for t in range(src_t.shape[1]):
        v = src_t[:, t]
        wv = w_taps[t] * v
        s1 = s1 + wv
        s2 = s2 + wv * v
        s3 = s3 + wref_taps[t] * v
    return s1, s2, s3


def _ncc_from_moments(inv, sum_wref, sum_wref2, s1, s2, s3, in_view
                      ) -> torch.Tensor:
    """Moments -> cost [*P, V] (views moved last)."""
    m_ref = sum_wref * inv
    m_ref2 = sum_wref2 * inv
    m_src = s1 * inv
    m_src2 = s2 * inv
    m_refsrc = s3 * inv
    var_ref = m_ref2 - m_ref * m_ref
    var_src = m_src2 - m_src * m_src
    covar = m_refsrc - m_ref * m_src
    var_prod = fmath.sqrt(torch.clamp(var_ref * var_src, min=0.0))
    ncc = covar / torch.clamp(var_prod, min=1e-30)
    cost = torch.clamp(1.0 - ncc, 0.0, COST_MAX)
    degenerate = (var_ref < _K_MIN_VAR) | (var_src < _K_MIN_VAR)
    cost = torch.where(degenerate | ~in_view, torch.full_like(cost, COST_MAX),
                       cost)
    return torch.movedim(cost, 0, -1)


def _ncc_cost_exact(ctx: CostContext, plane: torch.Tensor) -> torch.Tensor:
    """Reference-exact NCC: per-tap homography warp of the center plane.
    plane [H, W, 4] -> cost [H, W, V]."""
    base, colx, coly = _warp_terms(ctx, plane)
    in_view = _center_inview(base, ctx.src_wh)
    s1, s2, s3 = _window_moments(ctx.src_imgs, base, colx, coly, ctx.radius,
                                 ctx.w_taps, ctx.wref_taps)
    return _ncc_from_moments(1.0 / ctx.sum_w, ctx.sum_wref, ctx.sum_wref2,
                             s1, s2, s3, in_view)


def warp_field(ctx: CostContext, plane: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warped source field W[v](p) = src_v(H_{plane(p)}(p)) and the center
    in-view mask: plane [H, W, 4] -> (warped [V, H, W], in_view
    [V, H, W]).  One bilinear sample per (view, pixel), through K5."""
    from .warp_fused import warp_field as k5
    return k5(plane, ctx.src_imgs, ctx.M, ctx.b, ctx.cam, ctx.src_wh)


# planes and calls (batches) evaluated by ncc_cost_batch, by backend
PLANES_EVALUATED = {b: 0 for b in ("exact", "fused", "warp")}
BATCHES_EVALUATED = {b: 0 for b in ("exact", "fused", "warp")}


def ncc_cost(ctx: CostContext, plane: torch.Tensor,
             parity: Optional[int] = None) -> torch.Tensor:
    """Bilateral-NCC cost of one plane field: plane [H', W', 4] -> cost
    [H', W', V] in [0, 2].  ``parity`` (fused backend only) evaluates on a
    checkerboard-packed half grid whose ctx fields are packed to match."""
    return ncc_cost_batch(ctx, plane[None], parity=parity)[0]


def ncc_cost_batch(ctx: CostContext, planes: torch.Tensor,
                   parity: Optional[int] = None) -> torch.Tensor:
    """planes [B, H', W', 4] -> costs [B, H', W', V].

    The fused and warp backends evaluate all B planes in one kernel launch
    (the warp backend on the full grid only); the exact backend one plane at
    a time on the full grid."""
    PLANES_EVALUATED[ctx.backend] += planes.shape[0]
    BATCHES_EVALUATED[ctx.backend] += 1
    if ctx.backend == "fused":
        from .ncc_fused import fused_cost_from_ctx
        return fused_cost_from_ctx(ctx, planes, parity=parity)
    if parity is not None:
        raise ValueError(f"the {ctx.backend} backend evaluates the full "
                         "grid only")
    if ctx.backend == "warp":
        from .warp_fused import warp_ncc
        return warp_ncc(planes, ctx.src_imgs, ctx.M, ctx.b, ctx.cam,
                        ctx.src_wh, ctx.w_taps, ctx.wref_taps, ctx.sum_w,
                        ctx.sum_wref, ctx.sum_wref2, ctx.strong_radius,
                        y0=ctx.y0)
    return torch.stack([_ncc_cost_exact(ctx, p) for p in planes])
