"""Weak-pixel machinery, the part FIRST_INIT needs (counterpart of
``dvpmvs/kernels/weak.py``): ``edge_ray_distance``, which every pass with an
edge map computes (patchmatch.py:650-652).  The anchors, RANSAC fit and the
deformable cost belong to the APD slice of the port.
"""

from __future__ import annotations

import math

import torch

from .propagation import _in_bounds_mask, shift_map

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
