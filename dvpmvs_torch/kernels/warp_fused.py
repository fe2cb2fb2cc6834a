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

import ctypes

import numpy as np
import torch

from . import _build
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
    if plane.device.type == "cpu":
        return warp_field_plain(plane, src, M, b, cam, src_wh)
    if plane.device.type != "cuda":
        raise ValueError(f"warp_field: unsupported device {plane.device}")

    plane = plane.contiguous()
    if plane.data_ptr() % 16:
        raise ValueError("warp_field: the plane field must be 16-byte "
                         "aligned")
    mats = _mats(M, b)
    _build.require_cuda_inputs(_NAME, [plane, src, mats, cam, src_wh],
                               plane.device)
    warped = torch.empty((V, H, W), dtype=torch.float32, device=plane.device)
    in_view = torch.empty((V, H, W), dtype=torch.bool, device=plane.device)
    fn = _build.library(_NAME).launch_warp
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    P = _build.ptr
    err = fn(P(plane), P(src), P(mats), P(cam), P(src_wh), P(warped),
             P(in_view), V, H, W, ctypes.c_void_p(_build.stream_ptr(plane)))
    _build.check(err, _NAME, "field")
    return warped, in_view


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
    if planes.device.type == "cpu":
        return warp_ncc_plain(planes, src, M, b, cam, src_wh, w_taps,
                              wref_taps, sum_w, sum_wref, sum_wref2, radius,
                              y0)
    if planes.device.type != "cuda":
        raise ValueError(f"warp_ncc: unsupported device {planes.device}")

    planes = planes.contiguous()
    if planes.data_ptr() % 16:
        raise ValueError("warp_ncc: the plane fields must be 16-byte "
                         "aligned")
    mats = _mats(M, b)
    ins = [planes, src, mats, cam, src_wh, w_taps.contiguous(),
           wref_taps.contiguous(), sum_w.contiguous(), sum_wref.contiguous(),
           sum_wref2.contiguous()]
    _build.require_cuda_inputs(_NAME, ins, planes.device)
    # the kernel's block holds the halo of the largest shift; csrc/warp.cu
    # sizes it and refuses what exceeds a block's 227 KB
    shifts = tap_shifts(radius)
    lib = _build.library(_NAME)
    lib.warp_ncc_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.warp_ncc_smem_bytes.restype = ctypes.c_int
    halo = int(np.abs(shifts).max())
    if lib.warp_ncc_smem_bytes(V, halo) < 0:
        raise ValueError(f"warp_ncc: radius {radius} (halo {halo}) at V={V} "
                         "needs more shared memory than a block may have")
    out = torch.empty((B, Hin, W, V), dtype=torch.float32,
                      device=planes.device)
    if B == 0:
        return out
    fn = lib.launch_warp_ncc
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    table = np.ascontiguousarray(shifts)
    P = _build.ptr
    err = fn(*[P(t) for t in ins], table.ctypes.data_as(ctypes.c_void_p),
             P(out), B, V, H, W, Hin, int(y0),
             ctypes.c_void_p(_build.stream_ptr(planes)))
    _build.check(err, _NAME, "ncc")
    KERNEL_PLANES["ncc"] += B
    return out
