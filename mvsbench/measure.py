"""The benchmark's arithmetic, frozen so that later changes to the program
cannot move the yardstick.

Copied from ``chip_smoke.py`` of commit 3b5ba0b: ``acc2`` (an 8-px margin,
within 2 % of the ground truth), the union of device intervals behind its
``device_profile``, the H100's published peaks behind ``bound_ms``, and the
operation and byte counts of its kernel phase for K1 (``fused_ncc_costs``),
K2 (``sweep_weighted_ncc``), K3 (``geom_cost``), K4
(``anchor_slot_costs``) and the warp backend's NCC kernel (``warp_ncc``).
The counts take the shapes from a call's arguments, count each input byte
once and each output byte once, and count an FMA as 2 operations.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

MARGIN = 8
# H100 SXM published peaks (fp32 outside the tensor cores; HBM3), at 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Operation counts per unit of work, counted from each kernel's arithmetic
# (an FMA counts 2, a divide, clamp or floor 1), for the roofline bound.
K1_OPS_PER_TAP = 30          # warp (3 affine), divide, clamps, bilinear, moments
K1_OPS_PER_VIEW = 60         # homography terms, in-view test, NCC tail
K2_OPS_PER_FIELD = 35        # one warped-field bilinear sample
K2_OPS_PER_TAP = 7           # three moment updates from the field
K2_OPS_PER_VIEW = 30         # in-view test, NCC tail, weighted fold
K3_OPS_PER_VIEW = 54         # the composed form per (candidate, pixel, view)
K3_OPS_FOLD = 2              # the fold's weighted sum
K4_OPS_PER_ANCHOR = 70       # per (slot, pixel, view, anchor)
K4_OPS_PER_GROUP = 25        # the group's NCC from its moments
K4_OPS_PER_VIEW = 10         # the groups' mean and the out-of-view blend
K4_OPS_PER_TAP = 80          # tap mode, per tap of an anchor
K5_OPS_PER_VIEW = 46
K5_OPS_PER_PIXEL = 9
WARP_NCC_OPS_PER_VIEW = K5_OPS_PER_VIEW + 36 * 6 + 18
WARP_NCC_OPS_PER_PIXEL = K5_OPS_PER_PIXEL + 5
TAPS = 36                    # the window taps of r = 5


def acc2(depth: np.ndarray, gt: np.ndarray) -> float:
    """Share of interior pixels (8-px margin) within 2 % of ``gt``."""
    d = depth[MARGIN:-MARGIN, MARGIN:-MARGIN]
    g = gt[MARGIN:-MARGIN, MARGIN:-MARGIN]
    rel = np.abs(d - g) / np.maximum(g, 1e-6)
    return float(((rel < 0.02) & (d > 0)).mean())


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [a, b) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
              ) -> list:
    """The gaps in [lo, hi) that no interval covers, as (start, end)."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) by the nearest rank: the smallest
    value with at least q % of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(1, int(np.ceil(q / 100.0 * len(xs))))
    return float(xs[rank - 1])


def bound_s(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take: (seconds, what bounds it)."""
    t_ops = ops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_work(B: int, Hp: int, Wp: int, V: int, H: int, W: int,
            radius_map: bool) -> Tuple[float, float]:
    """K1: B plane fields on an H' x W' grid against V sources of H x W."""
    P = Hp * Wp
    ops = P * B * V * (TAPS * K1_OPS_PER_TAP + K1_OPS_PER_VIEW)
    nbytes = 4 * (B * P * 4 + 2 * TAPS * P + 3 * P + V * H * W
                  + (P if radius_map else 0) + B * P * V)
    return ops, nbytes


def k2_work(K: int, H: int, W: int, V: int) -> Tuple[float, float]:
    """K2: the K-step sweep over H x W against V sources."""
    ops = H * W * V * K * (K2_OPS_PER_FIELD + TAPS * K2_OPS_PER_TAP
                           + K2_OPS_PER_VIEW)
    nbytes = 4 * (2 * H * W + V * H * W + 2 * TAPS * H * W + 3 * H * W
                  + V * H * W + K * H * W)
    return ops, nbytes


def k3_work(K: int, Hp: int, Wp: int, V: int, H: int, W: int, fold: bool
            ) -> Tuple[float, float]:
    """K3: K candidate depth fields on H' x W' against V source depth maps
    of H x W, folded over the views or per view."""
    ops = K * Hp * Wp * V * (K3_OPS_PER_VIEW + (K3_OPS_FOLD if fold else 0))
    nbytes = 4 * (K * Hp * Wp + V * H * W
                  + (V * Hp * Wp + K * Hp * Wp if fold else K * Hp * Wp * V))
    return ops, nbytes


def k4_work(S: int, K: int, V: int, A: int, H: int, W: int, n_weak: int,
            n_kv: int, n_taps: int) -> Tuple[float, float]:
    """K4: S slots at K compacted entries, A anchors, V sources of H x W;
    ``n_weak`` entries with a usable anchor, ``n_kv`` (entry, view) pairs
    with one, ``n_taps`` taps per anchor (0 in the single-tap mode)."""
    ops = S * n_kv * (A * (K4_OPS_PER_ANCHOR + n_taps * K4_OPS_PER_TAP)
                      + 2 * K4_OPS_PER_GROUP + K4_OPS_PER_VIEW)
    nbytes = (5 * S * K * V + 4 * A * K + 4 * n_weak * (3 * S + 4 * A)
              + 4 * n_taps * A * n_kv + 4 * V * H * W)
    return ops, nbytes


def warp_ncc_work(B: int, Hin: int, W: int, V: int, H: int
                  ) -> Tuple[float, float]:
    """The warp backend's NCC: B planes on Hin x W rows, V sources."""
    ops = B * Hin * W * (V * WARP_NCC_OPS_PER_VIEW + WARP_NCC_OPS_PER_PIXEL)
    nbytes = 4 * (4 * B * Hin * W + B * Hin * W * V + 2 * TAPS * Hin * W
                  + 3 * Hin * W + V * H * W)
    return ops, nbytes
