"""Weak-pixel machinery (counterpart of ``dvpmvs/kernels/weak.py``).

Oracles (the reference's per-pixel walks, re-designed by dvpmvs for dense
execution and kept so here):
  * ``FindNearestStrongPoint`` (APD.cu:4159-4193): jump flooding
    (``nearest_strong``).
  * ``GenEdgeInform`` (APD.cu:3731-3890): nearest-edge and label-boundary
    ray distances, edge-density complexity, use_detail demotion.
  * ``GenNeighbours`` (APD.cu:3330-3711): directional STRONG-anchor search
    with nearest-strong redirect and edge-crossing limits, then a RANSAC
    plane vote over random triads; the 11 anchors nearest the plane are
    kept (``find_anchors``).
  * ``RANSACToGetFitPlane`` (APD.cu:4195-4404): per-iteration fit plane and
    adaptive NCC radius, with bug B2 fixed (``ransac_fit_plane``).

Dense layout: anchors live in [A, H, W] coordinate planes.  The random
triads come from the draw source (``rng.py``) under the JAX key paths of the
same sites.  Where JAX selects per pixel with a one-hot sum over the small
candidate axis (a TPU workaround), this module uses ``torch.gather``: the
same values.  ``patch_candidates`` (GenEdgeInform a, APD.cu:3744-3794) gives
the per-view sparse-patch offsets of the anchor term's tap mode
(``PMStatic.anchor_taps > 1``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import fmath
from ..config import PixelState
from ..geometry.camera import Camera
from ..rng import DrawSource, KeyPath, fold_in
from .ncc import _guard
from .propagation import _in_bounds_mask, shift_map, shift_rows


def _int_grid(H: int, W: int, device):
    ys = torch.arange(H, dtype=torch.int32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    return xs.expand(H, W), ys.expand(H, W)


# ---------------------------------------------------------------------------
# nearest strong pixel (jump flooding)
# ---------------------------------------------------------------------------

def nearest_strong(weak: torch.Tensor, max_radius: int = 100
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate nearest-STRONG coordinates per pixel.

    Returns (coords [H, W, 2] int32 (x, y), valid [H, W]).  STRONG pixels
    map to themselves."""
    H, W = weak.shape
    dev = weak.device
    xs, ys = _int_grid(H, W, dev)
    strong = weak == PixelState.STRONG
    neg = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    best_x = torch.where(strong, xs, neg)
    best_y = torch.where(strong, ys, neg)
    INF = 1 << 28
    best_d = torch.where(strong, torch.zeros_like(xs),
                         torch.full_like(xs, INF))
    steps = []
    step = 1
    while step <= max_radius:
        steps.append(step)
        step *= 2
    for s in reversed(steps):
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dx == 0 and dy == 0:
                    continue
                inb = _in_bounds_mask(H, W, dx, dy, dev)
                cx = shift_map(best_x, dx, dy)
                cy = shift_map(best_y, dx, dy)
                ok = inb & (cx >= 0)
                d = torch.where(ok, (cx - xs) ** 2 + (cy - ys) ** 2,
                                torch.full_like(xs, INF))
                better = d < best_d
                best_x = torch.where(better, cx, best_x)
                best_y = torch.where(better, cy, best_y)
                best_d = torch.minimum(best_d, d)
    valid = (best_d <= max_radius * max_radius) & (best_x >= 0)
    return torch.stack([best_x, best_y], dim=-1), valid


_RAY_DIRS = ((0, -1), (0, 1), (-1, 0), (1, 0),
             (-1, -1), (1, 1), (-1, 1), (1, -1))

_BIG = 1e9


def _minplus_scan(v: torch.Tensor, axis: int, reverse: bool) -> torch.Tensor:
    """out[i] = min_{k>=i}(v[k] + (k - i)) along ``axis`` (or k<=i reversed),
    by log-doubling with static shifts."""
    n = v.shape[axis]
    out = v
    shift = 1
    shape = [1] * v.dim()
    shape[axis] = n
    idx = torch.arange(n, device=v.device).reshape(shape)
    while shift < n:
        rolled = torch.roll(out, -shift if not reverse else shift, dims=axis)
        ok = (idx + shift < n) if not reverse else (idx - shift >= 0)
        cand = torch.where(ok, rolled + shift, torch.full_like(rolled, _BIG))
        out = torch.minimum(out, cand)
        shift *= 2
    return out


def _shear_fwd(v: torch.Tensor, sign: int) -> torch.Tensor:
    """Align diagonals into columns: out [H, W+H] with
    out[y, x - sign*y + (H if sign>0 else 0)] = v[y, x]; rest = BIG."""
    H, W = v.shape
    off = H if sign > 0 else 0
    ys = torch.arange(H, device=v.device)[:, None]
    js = torch.arange(W + H, device=v.device)[None, :]
    src_x = js - off + sign * ys
    ok = (src_x >= 0) & (src_x < W)
    got = torch.gather(v, 1, torch.clamp(src_x, 0, W - 1).expand(H, W + H))
    return torch.where(ok, got, torch.full_like(got, _BIG))


def _shear_back(S: torch.Tensor, sign: int, W: int) -> torch.Tensor:
    """Inverse of ``_shear_fwd``: out[y, x] = S[y, x - sign*y + off]."""
    H = S.shape[0]
    off = H if sign > 0 else 0
    ys = torch.arange(H, device=S.device)[:, None]
    xs = torch.arange(W, device=S.device)[None, :]
    j = torch.clamp(xs - sign * ys + off, 0, S.shape[1] - 1)
    return torch.gather(S, 1, j.expand(H, W))


def edge_ray_distance(edge: torch.Tensor) -> torch.Tensor:
    """Euclidean distance to the first edge pixel along each of 8 rays.

    edge [H, W] bool -> dist [8, H, W] float (BIG when no edge before the
    border), in _RAY_DIRS order (GenEdgeInform's ray walk,
    APD.cu:3799-3824)."""
    H, W = edge.shape
    v = torch.where(edge, torch.zeros(edge.shape, device=edge.device),
                    torch.full(edge.shape, _BIG, device=edge.device))

    def offset1(dist, dx, dy, scale):
        inb = _in_bounds_mask(H, W, dx, dy, edge.device)
        d = torch.where(inb, shift_map(dist, dx, dy) + 1.0,
                        torch.full_like(dist, _BIG))
        return torch.where(d >= _BIG, torch.full_like(d, _BIG), d * scale)

    up = _minplus_scan(v, 0, reverse=True)
    down = _minplus_scan(v, 0, reverse=False)
    left = _minplus_scan(v, 1, reverse=True)
    right = _minplus_scan(v, 1, reverse=False)

    S_pp = _shear_fwd(v, +1)
    S_pm = _shear_fwd(v, -1)
    d_dr = _shear_back(_minplus_scan(S_pp, 0, reverse=False), +1, W)
    d_ul = _shear_back(_minplus_scan(S_pp, 0, reverse=True), +1, W)
    d_dl = _shear_back(_minplus_scan(S_pm, 0, reverse=False), -1, W)
    d_ur = _shear_back(_minplus_scan(S_pm, 0, reverse=True), -1, W)

    sq2 = math.sqrt(2.0)
    parts = [
        offset1(up, 0, -1, 1.0), offset1(down, 0, 1, 1.0),
        offset1(left, -1, 0, 1.0), offset1(right, 1, 0, 1.0),
        offset1(d_ul, -1, -1, sq2), offset1(d_dr, 1, 1, sq2),
        offset1(d_dl, -1, 1, sq2), offset1(d_ur, 1, -1, sq2),
    ]
    return torch.stack(parts)


def label_boundary_distance(label: torch.Tensor) -> torch.Tensor:
    """Distance to the first label change along each of 8 rays ([8, H, W],
    the reference's "last same-label point" walk, APD.cu:3852-3889)."""
    H, W = label.shape
    dev = label.device
    dists = []
    for (dx, dy) in _RAY_DIRS:
        inb = _in_bounds_mask(H, W, dx, dy, dev)
        change = torch.where(inb, shift_map(label, dx, dy) != label,
                             torch.ones_like(inb))
        v = torch.where(change, torch.zeros((H, W), device=dev),
                        torch.full((H, W), _BIG, device=dev))
        if dy == 0:
            d = _minplus_scan(v, 1, reverse=dx < 0)
        elif dx == 0:
            d = _minplus_scan(v, 0, reverse=dy < 0)
        else:
            sign = +1 if dx == dy else -1
            d = _shear_back(
                _minplus_scan(_shear_fwd(v, sign), 0, reverse=dy < 0),
                sign, W)
        dists.append(d)
    return torch.stack(dists)


# ---------------------------------------------------------------------------
# complexity + detail demotion (GenEdgeInform c/d)
# ---------------------------------------------------------------------------

def edge_complexity(edge: torch.Tensor, radius: int = 5) -> torch.Tensor:
    """sigma(25 (edge density in the (2r+1)^2 window - 0.35))
    (APD.cu:3826-3845)."""
    H, W = edge.shape
    dev = edge.device
    e = edge.to(torch.float32)
    cnt = torch.zeros((H, W), device=dev)
    tot = torch.zeros((H, W), device=dev)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            inb = _in_bounds_mask(H, W, dx, dy, dev)
            cnt = cnt + torch.where(inb, shift_map(e, dx, dy),
                                    torch.zeros_like(e))
            tot = tot + inb.to(torch.float32)
    density = cnt / torch.clamp(tot, min=1.0)
    return fmath.sigmoid(25.0 * (density - 0.35))


def demote_detail(weak: torch.Tensor, edge: Optional[torch.Tensor],
                  label: Optional[torch.Tensor]) -> torch.Tensor:
    """REFINE_INIT use_detail: edge and label-0 pixels that are not STRONG
    become UNKNOWN (APD.cu:3847-3849, 3886-3888)."""
    demote = torch.zeros(weak.shape, dtype=torch.bool, device=weak.device)
    if edge is not None:
        demote = demote | edge.to(torch.bool)
    if label is not None:
        demote = demote | (label == 0)
    hit = demote & (weak != PixelState.STRONG)
    return torch.where(hit, torch.full_like(weak, int(PixelState.UNKNOWN)),
                       weak).to(torch.int8)


# ---------------------------------------------------------------------------
# per-view sparse-patch candidate offsets (GenEdgeInform a)
# ---------------------------------------------------------------------------

def _angular_region(dx: int, dy: int) -> int:
    ang = math.degrees(math.atan2(dy, dx))
    if ang < 0:
        ang += 360.0
    return min(int(ang // 30), 11)


def patch_candidates(ref_img: torch.Tensor, sel_views: torch.Tensor,
                     sigma_color, weak_radius: int = 5,
                     num_out: int = 8) -> torch.Tensor:
    """Visibility-aware sparse patch offsets per (pixel, view): the window
    offsets bucketed into 12 angular regions, the VISIBLE offset of largest
    bilateral weight kept per region, then the ``num_out`` regions of
    largest weight (APD.cu:3744-3794).

    Returns offsets [V, num_out, H, W, 2] int8 ((0, 0) = an empty slot).
    The sort is stable, as ``jnp.argsort``: equal weights (textureless
    neighbours, or empty regions at -inf) keep region order."""
    H, W = ref_img.shape
    V = sel_views.shape[-1]
    dev = ref_img.device
    sc = torch.as_tensor(sigma_color, dtype=torch.float32, device=dev)
    offsets = [(dx, dy) for dy in range(-weak_radius, weak_radius + 1)
               for dx in range(-weak_radius, weak_radius + 1)
               if not (dx == 0 and dy == 0)]
    # view-independent: in-bounds masks and bilateral weights per offset
    weights = []
    for dx, dy in offsets:
        pix = shift_map(ref_img, dx, dy)
        wgt = fmath.exp(-torch.abs(pix - ref_img) / (2.0 * sc * sc))
        weights.append((_in_bounds_mask(H, W, dx, dy, dev), wgt))
    neg_inf = torch.full((H, W), float("-inf"), device=dev)
    out = []
    for v in range(V):
        sel_v = sel_views[..., v]
        reg_w = [neg_inf] * 12
        reg_dx = [torch.zeros((H, W), dtype=torch.int8, device=dev)] * 12
        reg_dy = list(reg_dx)
        for (dx, dy), (inb, wgt) in zip(offsets, weights):
            reg = _angular_region(dx, dy)
            vis = inb & shift_map(sel_v, dx, dy)
            w = torch.where(vis, wgt, neg_inf)
            better = w > reg_w[reg]
            reg_w[reg] = torch.where(better, w, reg_w[reg])
            reg_dx[reg] = torch.where(better, dx, reg_dx[reg])
            reg_dy[reg] = torch.where(better, dy, reg_dy[reg])
        w_stack = torch.stack(reg_w)                         # [12, H, W]
        top = torch.argsort(-w_stack, dim=0, stable=True)[:num_out]
        odx = torch.gather(torch.stack(reg_dx), 0, top)
        ody = torch.gather(torch.stack(reg_dy), 0, top)
        empty = ~torch.isfinite(torch.gather(w_stack, 0, top))
        odx = torch.where(empty, torch.zeros_like(odx), odx)
        ody = torch.where(empty, torch.zeros_like(ody), ody)
        out.append(torch.stack([odx, ody], dim=-1))          # [8, H, W, 2]
    return torch.stack(out)


# ---------------------------------------------------------------------------
# anchor generation (GenNeighbours): static ray tables + redirect
# ---------------------------------------------------------------------------

NUM_ANCHORS = 11        # reference NEIGHBOUR_NUM - 1

_BASE_DIRS = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
              (0, 1), (1, -1), (1, 0), (1, 1)]


def _ray_offsets(max_extent: int):
    """Radius schedule r = 2, min(2r, r+25) ... (APD.cu:3404)."""
    radii = []
    r = 2
    while r <= max_extent:
        radii.append(r)
        r = min(2 * r, r + 25)
    return radii


class AnchorResult(NamedTuple):
    coords: torch.Tensor    # [A, H, W, 2] int32 (x, y); -1 = invalid
    valid: torch.Tensor     # [A, H, W] bool
    reliable: torch.Tensor  # [H, W] bool


def _plane_depth(n0, n1, n2, w, rx, ry):
    """Depth of plane (n, w) along ray (rx, ry, 1): -w / (n . r)."""
    return -w / _guard(n0 * rx + n1 * ry + n2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _norm3(n: torch.Tensor) -> torch.Tensor:
    return fmath.sqrt(_dot(n, n))


def _pick(field: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """field [D, H, W, C], sel [H, W] int -> field[sel[y, x], y, x] [H, W, C]
    (the one-hot sums of JAX, as a gather)."""
    idx = sel.to(torch.int64)[None, ..., None].expand(
        (1,) + tuple(sel.shape) + (field.shape[-1],))
    return torch.gather(field, 0, idx)[0]


def _point_in_triangle(A, B, C, px, py):
    """Barycentric sign test; A/B/C [..., 2] (int or float)."""
    ax, ay = A[..., 0].to(torch.float32), A[..., 1].to(torch.float32)
    bx, by = B[..., 0].to(torch.float32), B[..., 1].to(torch.float32)
    cx, cy = C[..., 0].to(torch.float32), C[..., 1].to(torch.float32)
    d1 = (px - bx) * (ay - by) - (ax - bx) * (py - by)
    d2 = (px - cx) * (by - cy) - (bx - cx) * (py - cy)
    d3 = (px - ax) * (cy - ay) - (cx - ax) * (py - ay)
    neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(neg & pos)


def find_anchors(
    weak: torch.Tensor,                 # [H, W] int8
    plane: torch.Tensor,                # [H, W, 4] current hypotheses
    ref_cam: Camera,
    draws: DrawSource,
    path: KeyPath,                      # JAX's k_weak
    rotate_time: int = 4,
    edge: Optional[torch.Tensor] = None,
    complexity: Optional[torch.Tensor] = None,
    ransac_threshold=0.005,
    depth_range=1.0,
    use_limit: bool = True,
    ransac_iters: int = 50,
    label: Optional[torch.Tensor] = None,        # [H, W] int labels
    label_dist: Optional[torch.Tensor] = None,   # [8, H, W]
    rows=None,
) -> AnchorResult:
    """Directional STRONG-anchor search + RANSAC reliability vote.

    Returns the best NUM_ANCHORS anchors per weak pixel, sorted by distance
    to the RANSAC plane, and the reliability mask.  With ``label`` and
    ``label_dist`` labeled weak pixels gain in-region candidates along the 8
    rays and RANSAC prefers "strong" planes (APD.cu:3461-3539, 3629-3652).
    With ``rows`` (an ``engine.rows.RowWindow``) only the window's compute
    rows are searched, along rays over the whole inputs: the draws are
    taken at the whole grid and cut to the window, so the result equals
    those rows of the whole search."""
    H, W = weak.shape
    dev = weak.device
    win_rows = (lambda a, axis=0: a) if rows is None else rows.take
    shift = lambda a, dx, dy: shift_rows(a, dx, dy, rows)
    strong = weak == PixelState.STRONG
    ns_coords, ns_valid = nearest_strong(weak)
    xs, ys = (win_rows(g) for g in _int_grid(H, W, dev))
    Hc = xs.shape[0]

    angle = 45.0 / rotate_time
    cone_cos = math.cos(math.radians(angle / 2.0))
    dirs = []
    for bx, by in _BASE_DIRS:
        norm = math.hypot(bx, by)
        base_ang = math.atan2(by / norm, bx / norm)
        for rot in range(rotate_time):
            a = base_ang + math.radians(angle * rot)
            dirs.append((math.cos(a), math.sin(a)))

    max_extent = max(H, W)
    radii = _ray_offsets(max_extent)
    edge_b = edge.to(torch.bool) if edge is not None else None
    if use_limit and complexity is not None:
        bypass = (win_rows(draws.uniform(path, (H, W)))
                  < win_rows(complexity))
    else:
        bypass = torch.zeros((Hc, W), dtype=torch.bool, device=dev)

    # the plane at each pixel's nearest strong point, gathered once; the
    # walk carries candidate planes beside the coordinates
    ns_idx = (torch.clamp(ns_coords[..., 1], 0, H - 1) * W
              + torch.clamp(ns_coords[..., 0], 0, W - 1))
    plane_ns = plane.reshape(-1, 4)[ns_idx.to(torch.int64)]
    neg1 = torch.full((Hc, W), -1, dtype=torch.int32, device=dev)
    no = torch.zeros((Hc, W), dtype=torch.bool, device=dev)
    zero_pl = torch.zeros((Hc, W, 4), dtype=plane.dtype, device=dev)

    anchor_x, anchor_y, anchor_ok, anchor_pl = [], [], [], []
    for (ux, uy) in dirs:
        found = no
        ax, ay = neg1, neg1
        apl = zero_pl
        blocked = no
        prev_dx = prev_dy = 0
        for r in radii:
            dx = int(round(ux * r))
            dy = int(round(uy * r))
            if abs(dx) >= W or abs(dy) >= H:
                break
            # edge crossing accumulates along the ray (midpoints between
            # consecutive radii)
            if edge_b is not None and use_limit:
                mx = (dx + prev_dx) // 2
                my = (dy + prev_dy) // 2
                for (sx, sy) in ((mx, my), (dx, dy)):
                    inb = _in_bounds_mask(H, W, sx, sy, dev, rows)
                    blocked = blocked | (inb & shift(edge_b, sx, sy))
            prev_dx, prev_dy = dx, dy

            inb = _in_bounds_mask(H, W, dx, dy, dev, rows)
            cand_strong = inb & shift(strong, dx, dy)
            red_x = shift(ns_coords[..., 0], dx, dy)
            red_y = shift(ns_coords[..., 1], dx, dy)
            red_ok = inb & shift(ns_valid, dx, dy)
            cx = torch.where(cand_strong, xs + dx, red_x)
            cy = torch.where(cand_strong, ys + dy, red_y)
            cpl = torch.where(cand_strong[..., None],
                              shift(plane, dx, dy),
                              shift(plane_ns, dx, dy))
            # angular-cone test (APD.cu:3437-3441) gates the redirects
            vx = (cx - xs).to(torch.float32)
            vy = (cy - ys).to(torch.float32)
            vn = torch.clamp(fmath.hypot(vx, vy), min=1e-6)
            in_cone = (vx * ux + vy * uy) / vn > cone_cos
            ok = (cand_strong | (red_ok & in_cone)) & (~blocked | bypass)
            take = ok & ~found
            ax = torch.where(take, cx, ax)
            ay = torch.where(take, cy, ay)
            apl = torch.where(take[..., None], cpl, apl)
            found = found | take
        anchor_x.append(ax)
        anchor_y.append(ay)
        anchor_ok.append(found)
        anchor_pl.append(apl)

    if label is not None and label_dist is not None:
        sq2 = math.sqrt(2.0)
        lab_ok = win_rows(label) > 0
        margin = 6                      # reference min_margin (APD.cu:3347)
        ladder = [s for s in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
                              96, 128, 192, 256) if s < max(H, W)]
        for d_idx, (ux, uy) in enumerate(_RAY_DIRS):
            ldist = win_rows(label_dist[d_idx])
            steps_b = ldist / (sq2 if d_idx >= 4 else 1.0)
            has_b = (ldist < 1e8) & lab_ok
            for frac in (0.5, 1.0):
                reach = steps_b * frac
                ax, ay = neg1, neg1
                apl = zero_pl
                found = no
                for s in ladder:
                    dx, dy = ux * s, uy * s
                    if abs(dx) >= W or abs(dy) >= H:
                        break
                    sxp = xs + dx
                    syp = ys + dy
                    inb = ((sxp >= margin) & (sxp < W - margin)
                           & (syp >= margin) & (syp < H - margin))
                    oks = inb & (s <= reach) & has_b
                    cand_strong = oks & shift(strong, dx, dy)
                    red_x = shift(ns_coords[..., 0], dx, dy)
                    red_y = shift(ns_coords[..., 1], dx, dy)
                    red_ok = oks & shift(ns_valid, dx, dy)
                    cx = torch.where(cand_strong, sxp, red_x)
                    cy = torch.where(cand_strong, syp, red_y)
                    cpl = torch.where(cand_strong[..., None],
                                      shift(plane, dx, dy),
                                      shift(plane_ns, dx, dy))
                    take = cand_strong | red_ok     # keep the farthest
                    ax = torch.where(take, cx, ax)
                    ay = torch.where(take, cy, ay)
                    apl = torch.where(take[..., None], cpl, apl)
                    found = found | take
                anchor_x.append(ax)
                anchor_y.append(ay)
                anchor_ok.append(found)
                anchor_pl.append(apl)

    cand_x = torch.stack(anchor_x)          # [D, H, W]
    cand_y = torch.stack(anchor_y)
    cand_ok = torch.stack(anchor_ok)
    D = cand_x.shape[0]

    # candidate 3D points and normals (planes carried by the walk)
    a_plane = torch.stack(anchor_pl)        # [D, H, W, 4]
    fx, fy, cxk, cyk = ref_cam.fx, ref_cam.fy, ref_cam.cx, ref_cam.cy
    rx_a = (cand_x.to(torch.float32) - cxk) / fx
    ry_a = (cand_y.to(torch.float32) - cyk) / fy
    a_depth = _plane_depth(a_plane[..., 0], a_plane[..., 1],
                           a_plane[..., 2], a_plane[..., 3], rx_a, ry_a)
    a_pt = torch.stack([a_depth * rx_a, a_depth * ry_a, a_depth], dim=-1)
    a_norm = a_plane[..., :3]
    count = torch.sum(cand_ok, dim=0)

    # RANSAC vote over random triads
    # (the window's rows copied out: the whole draw is freed)
    tri = win_rows(draws.randint(fold_in(path, 1), (ransac_iters, 3, H, W),
                                 0, D), 2).contiguous()
    px = xs.to(torch.float32)
    py = ys.to(torch.float32)
    rx_p = (px - cxk) / fx
    ry_p = (py - cyk) / fy
    plane_c = win_rows(plane)
    center_depth = _plane_depth(plane_c[..., 0], plane_c[..., 1],
                                plane_c[..., 2], plane_c[..., 3], rx_p, ry_p)
    # one gather per triad vertex: point (3), normal (3), x, y, ok
    fields = torch.cat([a_pt, a_norm, cand_x[..., None].to(torch.float32),
                        cand_y[..., None].to(torch.float32),
                        cand_ok[..., None].to(torch.float32)], dim=-1)
    lab_pos = win_rows(label) > 0 if label is not None else None

    best_score = torch.full((Hc, W), float("-inf"), device=dev)
    fit4 = torch.zeros((Hc, W, 4), device=dev)
    for i in range(ransac_iters):
        ia, ib, ic = tri[i, 0], tri[i, 1], tri[i, 2]
        fa, fb, fc = _pick(fields, ia), _pick(fields, ib), _pick(fields, ic)
        A_, B_, C_ = fa[..., 0:3], fb[..., 0:3], fc[..., 0:3]
        AN, BN, CN = fa[..., 3:6], fb[..., 3:6], fc[..., 3:6]
        ok = (fa[..., 8] > 0) & (fb[..., 8] > 0) & (fc[..., 8] > 0)
        ok = ok & (ia != ib) & (ib != ic) & (ia != ic)
        # normals mutually aligned (APD.cu:3604-3608)
        ok = ok & ((_dot(AN, BN) >= 0.9) & (_dot(AN, CN) >= 0.9)
                   & (_dot(BN, CN) >= 0.9))
        ok = ok & _point_in_triangle(fa[..., 6:8], fb[..., 6:8],
                                     fc[..., 6:8], px, py)
        n = _cross(A_ - C_, B_ - C_)
        nn = _norm3(n)
        ok = ok & (nn > 1e-12)
        n = n / torch.clamp(nn[..., None], min=1e-12)
        w = -_dot(n, A_)
        # inliers among all D candidates
        fit_depth = _plane_depth(n[None, ..., 0], n[None, ..., 1],
                                 n[None, ..., 2], w[None], rx_a, ry_a)
        dist = torch.abs(fit_depth - a_pt[..., 2])
        inlier = cand_ok & (dist / depth_range < ransac_threshold)
        n_in = torch.sum(inlier, dim=0)
        ok = ok & (n_in >= 6)
        cd = _plane_depth(n[..., 0], n[..., 1], n[..., 2], w, rx_p, ry_p)
        center_dist = torch.abs(cd - center_depth)
        score = torch.where(ok, n_in.to(torch.float32) * 1e6
                            - torch.clamp(center_dist, max=1e5),
                            torch.full_like(center_dist, float("-inf")))
        if lab_pos is not None:
            # "strong plane" preference (APD.cu:3629-3652)
            weak_fit = (lab_pos & (torch.abs(_dot(AN, n)) < 0.9)
                        & (torch.abs(_dot(BN, n)) < 0.9)
                        & (torch.abs(_dot(CN, n)) < 0.9))
            score = score + torch.where(ok & ~weak_fit,
                                        torch.full_like(score, 1e12),
                                        torch.zeros_like(score))
        better = score > best_score
        fit4 = torch.where(better[..., None],
                           torch.cat([n, w[..., None]], dim=-1), fit4)
        best_score = torch.maximum(best_score, score)
    has_plane = torch.isfinite(best_score)

    # rank anchors by distance to the fitted plane, keep NUM_ANCHORS with
    # first-index tie-breaking (the stable order of the reference's sort)
    fit_depth_a = _plane_depth(fit4[None, ..., 0], fit4[None, ..., 1],
                               fit4[None, ..., 2], fit4[None, ..., 3],
                               rx_a, ry_a)
    a_dist = torch.abs(fit_depth_a - a_pt[..., 2])
    a_inlier = cand_ok & (a_dist / depth_range < ransac_threshold)
    key_i = torch.where(a_inlier, a_dist,
                        torch.full_like(a_dist, float("inf")))
    sel_x_l, sel_y_l, sel_ok_l = [], [], []
    for _ in range(NUM_ANCHORS):
        best = torch.min(key_i, dim=0).values
        is_min = key_i == best[None]
        first = is_min & (torch.cumsum(is_min.to(torch.int32), dim=0) == 1)
        ok_a = torch.isfinite(best)
        pick_x = torch.sum(torch.where(first, cand_x, torch.zeros_like(
            cand_x)), dim=0, dtype=torch.int32)
        pick_y = torch.sum(torch.where(first, cand_y, torch.zeros_like(
            cand_y)), dim=0, dtype=torch.int32)
        sel_x_l.append(torch.where(ok_a, pick_x, neg1))
        sel_y_l.append(torch.where(ok_a, pick_y, neg1))
        sel_ok_l.append(ok_a)
        key_i = torch.where(first, torch.full_like(key_i, float("inf")),
                            key_i)
    sel_x = torch.stack(sel_x_l)
    sel_y = torch.stack(sel_y_l)
    sel_ok = torch.stack(sel_ok_l)

    reliable = (win_rows(weak) == PixelState.WEAK) & has_plane & (count > 3)
    coords = torch.stack([sel_x, sel_y], dim=-1)
    return AnchorResult(coords=coords, valid=sel_ok & reliable[None],
                        reliable=reliable)


# ---------------------------------------------------------------------------
# per-iteration fit plane + adaptive radius (RANSACToGetFitPlane)
# ---------------------------------------------------------------------------

def ransac_fit_plane(
    anchors: AnchorResult,
    plane: torch.Tensor,                # [H, W, 4] current hypotheses
    weak: torch.Tensor,
    ref_cam: Camera,
    draws: DrawSource,
    path: KeyPath,
    iters: int = 50,
    use_radius: bool = False,
    strong_radius: int = 5,
    edge_dist: Optional[torch.Tensor] = None,      # [8, H, W]
    label_dist: Optional[torch.Tensor] = None,
    rows=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fit a plane through anchor triads minimising the summed depth
    residuals (APD.cu:4195-4404, bug B2 fixed: the radius triangle is the
    winning triad).  Returns (fit plane [H, W, 4], zeros where none) and
    the adaptive radius map (or None).  With ``rows`` (an
    ``engine.rows.RowWindow``) ``anchors`` and the results are on its
    compute rows; ``plane``, ``weak`` and the distance fields stay whole."""
    H, W = weak.shape
    dev = weak.device
    take = (lambda a, axis=0: a) if rows is None else rows.take
    A = anchors.coords.shape[0]
    ax_c = anchors.coords[..., 0]
    ay_c = anchors.coords[..., 1]
    a_ok = anchors.valid
    fx, fy, cxk, cyk = ref_cam.fx, ref_cam.fy, ref_cam.cx, ref_cam.cy
    idx = torch.clamp(ay_c, 0, H - 1) * W + torch.clamp(ax_c, 0, W - 1)
    a_plane = plane.reshape(-1, 4)[idx.to(torch.int64)]
    axf = ax_c.to(torch.float32)
    ayf = ay_c.to(torch.float32)
    rx_a = (axf - cxk) / fx
    ry_a = (ayf - cyk) / fy
    a_depth = _plane_depth(a_plane[..., 0], a_plane[..., 1],
                           a_plane[..., 2], a_plane[..., 3], rx_a, ry_a)
    a_pt = torch.stack([a_depth * rx_a, a_depth * ry_a, a_depth], dim=-1)
    a_norm = a_plane[..., :3]
    xs_i, ys_i = (take(g) for g in _int_grid(H, W, dev))
    xs = xs_i.to(torch.float32)
    ys = ys_i.to(torch.float32)
    Hc = xs.shape[0]

    tri = take(draws.randint(path, (iters, 3, H, W), 0, A), 2).contiguous()
    fields = torch.cat([a_pt, a_norm, axf[..., None], ayf[..., None],
                        a_ok[..., None].to(torch.float32)], dim=-1)

    best_cost = torch.full((Hc, W), float("inf"), device=dev)
    fit4 = torch.zeros((Hc, W, 4), device=dev)
    btri = torch.zeros((Hc, W, 3), dtype=torch.int32, device=dev)
    for i in range(iters):
        ia, ib, ic = tri[i, 0], tri[i, 1], tri[i, 2]
        fa, fb, fc = _pick(fields, ia), _pick(fields, ib), _pick(fields, ic)
        ok = (ia != ib) & (ib != ic) & (ia != ic)
        ok = ok & (fa[..., 8] > 0) & (fb[..., 8] > 0) & (fc[..., 8] > 0)
        Apt, Bpt, Cpt = fa[..., 0:3], fb[..., 0:3], fc[..., 0:3]
        AN, BN, CN = fa[..., 3:6], fb[..., 3:6], fc[..., 3:6]
        ok = ok & ((_dot(AN, BN) >= 0.9) & (_dot(AN, CN) >= 0.9)
                   & (_dot(BN, CN) >= 0.9))
        ok = ok & _point_in_triangle(fa[..., 6:8], fb[..., 6:8],
                                     fc[..., 6:8], xs, ys)
        n = _cross(Apt - Cpt, Bpt - Cpt)
        nn = _norm3(n)
        ok = ok & (nn > 1e-12)
        n = n / torch.clamp(nn[..., None], min=1e-12)
        w = -_dot(n, Apt)
        fit_depth = _plane_depth(n[None, ..., 0], n[None, ..., 1],
                                 n[None, ..., 2], w[None], rx_a, ry_a)
        resid = torch.where(a_ok, torch.abs(fit_depth - a_pt[..., 2]),
                            torch.zeros_like(fit_depth))
        cost = torch.where(ok, torch.sum(resid, dim=0),
                           torch.full_like(best_cost, float("inf")))
        better = cost < best_cost
        fit4 = torch.where(better[..., None],
                           torch.cat([n, w[..., None]], dim=-1), fit4)
        btri = torch.where(better[..., None],
                           torch.stack([ia, ib, ic], dim=-1), btri)
        best_cost = torch.minimum(best_cost, cost)
    has = (torch.isfinite(best_cost) & (take(weak) == PixelState.WEAK)
           & (torch.sum(a_ok, dim=0) >= 3))

    # orient toward the camera (APD.cu:4340-4347)
    ray = torch.stack([(xs - cxk) / fx, (ys - cyk) / fy,
                       torch.ones_like(xs)], dim=-1)
    flip = torch.sum(fit4[..., :3] * ray, dim=-1) > 0
    fit4 = torch.where(flip[..., None], -fit4, fit4)
    fit4 = torch.where(has[..., None], fit4, torch.zeros_like(fit4))

    radius_map = None
    if use_radius:
        def tri_xy(i):
            sel = btri[..., i].to(torch.int64)[None]
            return (torch.gather(axf, 0, sel)[0],
                    torch.gather(ayf, 0, sel)[0])
        Axx, Ayy = tri_xy(0)
        Bxx, Byy = tri_xy(1)
        Cxx, Cyy = tri_xy(2)
        la = fmath.hypot(Axx - Bxx, Ayy - Byy)
        lb = fmath.hypot(Bxx - Cxx, Byy - Cyy)
        lc = fmath.hypot(Cxx - Axx, Cyy - Ayy)
        p = (la + lb + lc) / 2.0
        S = fmath.sqrt(torch.clamp(p * (p - la) * (p - lb) * (p - lc),
                                   min=0.0))
        radius = torch.floor(fmath.sqrt(S) / 2.0)
        dmin = torch.minimum(torch.minimum(fmath.hypot(Axx - xs, Ayy - ys),
                                           fmath.hypot(Bxx - xs, Byy - ys)),
                             fmath.hypot(Cxx - xs, Cyy - ys))
        radius = torch.where(2.5 * dmin < radius, torch.floor(dmin), radius)
        if edge_dist is not None:
            radius = torch.minimum(radius, torch.min(take(edge_dist, 1),
                                                     dim=0).values)
        if label_dist is not None:
            radius = torch.minimum(radius, torch.min(take(label_dist, 1),
                                                     dim=0).values)
        # quantise down to (2r) % 5 == 0 (APD.cu:4394)
        radius = torch.floor(radius / 2.5) * 2.5
        radius = torch.where(radius < strong_radius,
                             torch.zeros_like(radius), radius)
        radius = torch.where(has, radius,
                             torch.full_like(radius, float(strong_radius)))
        radius_map = radius
    return fit4, radius_map
