"""K5: the warped source field of one plane field (counterpart of
``dvpmvs/kernels/sweep_pallas.py::warp_field_pallas`` and of
``dvpmvs/kernels/ncc.py::warp_field``).

``warp_field`` samples every source view once per reference pixel at the
pixel's own plane-induced homography: warped [V, H, W] and in_view
[V, H, W].  It launches ``csrc/warp.cu`` for tensors on the card and runs
``warp_field_plain`` (the same function in plain PyTorch) for tensors on the
CPU.  The plane enters as (n, w), as ``ncc.warp_field`` takes it (the TPU
kernel takes an inverse depth), and the sources are fp32 (the TPU kernel
reads u8 packed quads).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ncc import _base_fields, _bilinear_sample_batch, _center_coords, _grid
from .ncc_fused import _mats

_NAME = "warp"


def warp_coords(plane, M, b, cam, src_wh):
    """The source coordinates (px, py) [V, H, W] of every reference pixel
    under its own plane, and the in-view mask: K5 before its sample."""
    H, W = plane.shape[:2]
    xs, ys = _grid(H, W, plane.device)
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
    _build.check(err, _NAME)
    return warped, in_view
