"""K5: the warped source field of one plane field (counterpart of
``dvpmvs/kernels/sweep_pallas.py::warp_field_pallas`` and of
``dvpmvs/kernels/ncc.py::warp_field``), and the "warp" cost backend's NCC
of a batch of plane fields built on it (counterpart of JAX's
``dvpmvs/kernels/ncc.py::_ncc_cost_warp``, plane by plane).

``warp_field`` samples every source view once per reference pixel at the
pixel's own plane-induced homography: warped [V, H, W] and in_view
[V, H, W].  ``warp_ncc`` is the whole cost of a candidate batch on that
field: the 36 taps read it at static integer shifts of the static radius
(wrapping), and the NCC is formed from their moments.  Each launches
``csrc/warp.cu`` (``launch_warp``, ``launch_warp_ncc``: one launch a batch)
for tensors on the card and runs its plain PyTorch version
(``warp_field_plain``, ``warp_ncc_plain``) for tensors on the CPU.  The
plane enters as (n, w), as ``ncc.warp_field`` takes it (the TPU kernel
takes an inverse depth), and the sources are fp32 (the TPU kernel reads u8
packed quads).
"""

from __future__ import annotations


import numpy as np
import torch

from .ncc import (_base_fields, _bilinear_sample_batch, _center_coords,
                  _grid, _ncc_from_moments, shift2, tap_grid)
from .ncc_fused import _mats

_NAME = "warp"
# planes costed by launches of launch_warp_ncc (a batch is one launch)
KERNEL_PLANES = {"ncc": 0}


def warp_coords(plane, M, b, cam, src_wh, y0: int = 0, H: int = 0):
    """The source coordinates (px, py) [V, H', W] of every reference pixel
    under its own plane, and the in-view mask: K5 before its sample.  The
    plane rows are image rows (y0 + i) mod H (the whole image by
    default)."""
    Hp, W = plane.shape[:2]
    xs, ys = _grid(Hp, W, plane.device)
    if y0 or (H and Hp > H):
        ys = torch.remainder(ys + float(y0), float(H))
    rx = (xs - cam[0]) / cam[2]
    ry = (ys - cam[1]) / cam[3]
    n0, n1, n2, w_d = plane.unbind(-1)
    s = (n0 * rx + n1 * ry + n2) / w_d
    return _center_coords(_base_fields(M, b, rx, ry, s), src_wh)


def warp_field_plain(plane, src, M, b, cam, src_wh):
    """The plain version of K5: same arguments, same result."""
    px, py, in_view = warp_coords(plane, M, b, cam, src_wh)
    return _bilinear_sample_batch(src, px, py), in_view


def warp_field(plane, src, M, b, cam, src_wh):
    """plane [H, W, 4] (n, w); src [V, H, W] fp32 sources; M [V, 3, 3] and
    b [V, 3] the homography terms; cam [4] (cx, cy, fx, fy) of the
    reference; src_wh [V, 2] -> (warped [V, H, W] f32, in_view [V, H, W]
    bool)."""
    H, W, four = plane.shape
    V = src.shape[0]
    if four != 4 or tuple(src.shape[1:]) != (H, W):
        raise ValueError(f"warp_field: inconsistent shapes plane "
                         f"{tuple(plane.shape)} src {tuple(src.shape)}")
    return warp_field_plain(plane, src, M, b, cam, src_wh)


def tap_shifts(radius: int) -> np.ndarray:
    """The 36 taps' integer shifts at the static radius, [2, 36] int32
    (dx row, dy row), in ``tap_grid`` order: the plain version reads the
    warped field at them and the kernel gets them by value."""
    taps = tap_grid()
    return np.array([[int(round(float(taps[t, k]) * radius))
                      for t in range(taps.shape[0])] for k in (0, 1)],
                    np.int32)


def warp_ncc_plain(planes, src, M, b, cam, src_wh, w_taps, wref_taps,
                   sum_w, sum_wref, sum_wref2, radius: int, y0: int = 0):
    """The plain version of ``warp_ncc``: same arguments, same result.
    Plane by plane, K5's plain field, then the 36 shifted taps' moments
    in tap order and the NCC."""
    B, Hin, W = planes.shape[:3]
    V, H = src.shape[:2]
    shifts = tap_shifts(radius)
    inv = 1.0 / sum_w
    out = []
    for plane in planes:
        px, py, in_view = warp_coords(plane, M, b, cam, src_wh, y0, H)
        warped = _bilinear_sample_batch(src, px, py)
        s1 = s2 = s3 = 0.0
        for t in range(shifts.shape[1]):
            src_t = shift2(warped, int(shifts[0, t]), int(shifts[1, t]))
            wv = w_taps[t] * src_t
            s1 = s1 + wv
            s2 = s2 + wv * src_t
            s3 = s3 + wref_taps[t] * src_t
        out.append(_ncc_from_moments(inv, sum_wref, sum_wref2, s1, s2, s3,
                                     in_view))
    if not out:
        return torch.empty((0, Hin, W, V), dtype=torch.float32,
                           device=planes.device)
    return torch.stack(out)


def warp_ncc(planes, src, M, b, cam, src_wh, w_taps, wref_taps, sum_w,
             sum_wref, sum_wref2, radius: int, y0: int = 0):
    """planes [B, H', W, 4] (n, w); src [V, H, W] fp32 sources; M [V, 3, 3],
    b [V, 3]; cam [4]; src_wh [V, 2]; w_taps, wref_taps [36, H', W] the tap
    weights; sum_w, sum_wref, sum_wref2 [H', W] their sums; radius the
    static int radius of the shifts -> cost [B, H', W, V] f32.

    The H' rows are image rows (y0 + i) mod H (the whole image: y0 = 0,
    H' = H).  A tap's row wraps within them: the image's wrap for the whole
    image; for a window of rows with |shift| rows of halo on each side the
    costs of the inner rows are the whole image's."""
    B, Hin, W, four = planes.shape
    V, H = src.shape[:2]
    if four != 4 or src.shape[2] != W or not -H < y0 < H or Hin > H or \
            tuple(w_taps.shape) != (36, Hin, W) or \
            tuple(wref_taps.shape) != (36, Hin, W) or \
            any(tuple(t.shape) != (Hin, W)
                for t in (sum_w, sum_wref, sum_wref2)):
        raise ValueError(f"warp_ncc: inconsistent shapes planes "
                         f"{tuple(planes.shape)} src {tuple(src.shape)} "
                         f"w_taps {tuple(w_taps.shape)} row origin {y0}")
    return warp_ncc_plain(planes, src, M, b, cam, src_wh, w_taps,
                          wref_taps, sum_w, sum_wref, sum_wref2, radius,
                          y0)


