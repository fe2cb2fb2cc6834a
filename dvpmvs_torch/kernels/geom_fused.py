"""K3: the batched geometric-consistency kernel (counterpart of
``dvpmvs/kernels/geom_pallas.py::geom_cost_pallas``, dense modes).

``geom_cost`` scores K candidate depth fields [K, H, W] against the source
depth maps: per view -> [K, H, W, V], or folded with per-pixel view weights
-> [K, H, W].  With ``parity`` 0/1 the fields live on one checkerboard color
[K, H, ceil(W/2)] (evaluation pixel (y, i) at x = 2 i + (y + parity) % 2,
engine/packing.py) and the result is per view [K, H, ceil(W/2), V]; the
source depth maps stay full resolution.  It launches ``csrc/geom.cu`` for
tensors on the card and runs ``geom_cost_plain``
(``geom.geom_consistency_cost`` over candidate chunks) for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from . import _build
from .geom import GeomContext, geom_consistency_cost
from .ncc_fused import eval_coords

_NAME = "geom"


def parity_context(gctx: GeomContext, parity: int) -> GeomContext:
    """``gctx`` with its per-pixel coordinate fields on one checkerboard
    color (x = 2 i + (y + parity) % 2, computed, not packed, so that the
    padding column of an odd width sits at x = W as in the kernel)."""
    H, W = gctx.xs.shape
    xs, ys = eval_coords(H, (W + 1) // 2, parity, gctx.xs.device)
    ref_K = gctx.ref_K
    return dataclasses.replace(gctx, xs=xs, ys=ys,
                               rx=(xs - ref_K[0, 2]) / ref_K[0, 0],
                               ry=(ys - ref_K[1, 2]) / ref_K[1, 1])


def geom_cost_plain(gctx: GeomContext, depth_stack: torch.Tensor,
                    vweights: Optional[torch.Tensor] = None,
                    fold: bool = False, chunk: int = 8,
                    parity: Optional[int] = None) -> torch.Tensor:
    """The plain version of K3: same arguments, same result."""
    if parity is not None:
        gctx = parity_context(gctx, parity)
    outs = []
    for k0 in range(0, depth_stack.shape[0], chunk):
        c = geom_consistency_cost(gctx, depth_stack[k0:k0 + chunk])
        if fold:                                # view order, as the kernel
            acc = c[..., 0] * vweights[..., 0]
            for v in range(1, c.shape[-1]):
                acc = acc + vweights[..., v] * c[..., v]
            c = acc
        outs.append(c)
    return torch.cat(outs)


def geom_cost(gctx: GeomContext, depth_stack: torch.Tensor,
              vweights: Optional[torch.Tensor] = None,
              fold: bool = False, parity: Optional[int] = None
              ) -> torch.Tensor:
    """Geom costs of K candidate depth fields depth_stack [K, H, W'].

    Returns [K, H, W', V], or with ``fold`` the ``vweights`` ([H, W, V])
    weighted sum over views [K, H, W].  W' is W, or ceil(W/2) with
    ``parity`` 0/1 (one checkerboard color; per view only)."""
    V, H, W = gctx.src_depths.shape
    K = depth_stack.shape[0]
    if parity not in (None, 0, 1):
        raise ValueError("geom_cost: parity must be None, 0 or 1")
    if parity is not None and fold:
        raise ValueError("geom_cost: the parity mode is per view only")
    Wp = W if parity is None else (W + 1) // 2
    if tuple(depth_stack.shape[1:]) != (H, Wp):
        raise ValueError(f"geom_cost: depth_stack must be [K, {H}, {Wp}], "
                         f"got {tuple(depth_stack.shape)}")
    if fold and (vweights is None or tuple(vweights.shape) != (H, W, V)):
        raise ValueError("geom_cost: fold needs vweights [H, W, V]")
    if depth_stack.device.type == "cpu":
        return geom_cost_plain(gctx, depth_stack, vweights, fold,
                               parity=parity)
    if depth_stack.device.type != "cuda":
        raise ValueError(f"geom_cost: unsupported device "
                         f"{depth_stack.device}")
    if V > 32:
        raise ValueError("geom_cost: at most 32 views on the card")

    cams = gctx.cam_rows
    if tuple(cams.shape) != (1 + V, 24) or cams.device.type != "cpu":
        raise ValueError("geom_cost: cam_rows must be [1 + V, 24] on the "
                         "host")
    depths = depth_stack.contiguous()
    vw = torch.movedim(vweights, -1, 0).contiguous() if fold else None
    _build.require_cuda_inputs(_NAME, [depths, gctx.src_depths, vw],
                               depths.device)
    shape = (K, H, Wp) if fold else (K, H, Wp, V)
    out = torch.empty(shape, dtype=torch.float32, device=depths.device)
    fn = _build.library(_NAME).launch_geom
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    P = _build.ptr
    # cams is read on the host when the kernel is launched (a by-value
    # launch argument), so it may be freed right after
    err = fn(P(depths), P(gctx.src_depths), P(cams), P(vw), P(out),
             K, V, H, W, Wp, -1 if parity is None else int(parity),
             ctypes.c_void_p(_build.stream_ptr(depths)))
    _build.check(err, _NAME, "fold" if fold else
                 "per view" if parity is None else "parity")
    return out
