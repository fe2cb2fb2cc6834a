"""Checkerboard median depth filter (counterpart of
``dvpmvs/kernels/median.py``; oracle ``CheckerboardFilterStrong``,
APD.cu:3184-3328): a 21-tap median over the center, cross arms at
+-1/+-3/+-5 and eight knight taps, restricted to STRONG neighbors, applied
to non-WEAK pixels unless their cost is < 0.001.  Black then red (red sees
black-filtered depths).  On a row window of the tiled pass each color
filters the window's rows against the whole depth map, then exchanges them.
"""

from __future__ import annotations

import torch

from ..config import PixelState
from .gatherfree import take0
from .propagation import _in_bounds_mask, shift_rows

_TAPS = [(0, 0),
         (0, -1), (0, -3), (0, -5), (0, 1), (0, 3), (0, 5),
         (-1, 0), (-3, 0), (-5, 0), (1, 0), (3, 0), (5, 0),
         (2, -1), (2, 1), (-2, -1), (-2, 1),
         (-1, -2), (1, -2), (-1, 2), (1, 2)]


def _masked_median(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """vals [T, H, W], valid [T, H, W] -> median over valid entries [H, W]."""
    big = torch.where(valid, vals, torch.full_like(vals, float("inf")))
    srt = torch.sort(big, dim=0).values
    n = torch.sum(valid, dim=0)
    T = vals.shape[0]
    mid = n // 2
    v_hi = take0(srt, torch.clamp(mid, 0, T - 1))
    v_lo = take0(srt, torch.clamp(mid - 1, 0, T - 1))
    even = (n % 2) == 0
    return torch.where(even, 0.5 * (v_lo + v_hi), v_hi)


def median_filter_depth(depth: torch.Tensor, weak: torch.Tensor,
                        cost: torch.Tensor, rows=None) -> torch.Tensor:
    """Two-color checkerboard 21-tap median of the depth map [H, W]; with
    ``rows`` (an ``engine.rows.RowWindow``) each color filters the compute
    rows and ``rows.commit`` makes the map whole again."""
    H, W = depth.shape
    dev = depth.device
    take = (lambda a: a) if rows is None else rows.take
    Hc = H if rows is None else rows.hc
    xs = torch.arange(W, device=dev)[None, :]
    ys = (torch.arange(H, device=dev) if rows is None
          else rows.row_ids(dev))[:, None]
    parity = (xs + ys) % 2
    strong = weak == PixelState.STRONG
    eligible = (take(weak) != PixelState.WEAK) & (take(cost) >= 0.001)

    valid = []
    for (dx, dy) in _TAPS:
        if dx == 0 and dy == 0:
            valid.append(torch.ones((Hc, W), dtype=torch.bool, device=dev))
        else:
            valid.append(_in_bounds_mask(H, W, dx, dy, dev, rows)
                         & shift_rows(strong, dx, dy, rows))
    valid = torch.stack(valid)
    for color in (0, 1):
        vals = torch.stack([shift_rows(depth, dx, dy, rows)
                            for (dx, dy) in _TAPS])
        med = _masked_median(vals, valid)
        filtered = torch.where(eligible & (parity == color), med,
                               take(depth))
        depth = filtered if rows is None else rows.commit(filtered)
    return depth
