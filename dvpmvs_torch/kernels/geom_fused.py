"""K3: the batched geometric-consistency kernel (counterpart of
``dvpmvs/kernels/geom_pallas.py::geom_cost_pallas``, dense modes).

``geom_cost`` scores K candidate depth fields [K, H, W] against the source
depth maps: per view -> [K, H, W, V], or folded with per-pixel view weights
-> [K, H, W].  It launches ``csrc/geom.cu`` for tensors on the card and runs
``geom_cost_plain`` (``geom.geom_consistency_cost`` over candidate chunks)
for tensors on the CPU.  The checkerboard-parity per-view mode of the TPU
kernel belongs to the weak-pixel (APD) slice of the port.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .geom import GeomContext, geom_consistency_cost

_NAME = "geom"


def _cam_rows(K, R, t, c) -> torch.Tensor:
    """[..., 24] camera constants: K (9), R (9), t (3), c (3)."""
    lead = K.shape[:-2]
    return torch.cat([K.reshape(lead + (9,)), R.reshape(lead + (9,)), t, c],
                     dim=-1).to(torch.float32).contiguous()


def geom_cost_plain(gctx: GeomContext, depth_stack: torch.Tensor,
                    vweights: Optional[torch.Tensor] = None,
                    fold: bool = False, chunk: int = 8) -> torch.Tensor:
    """The plain version of K3: same arguments, same result."""
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
              fold: bool = False) -> torch.Tensor:
    """Geom costs of K candidate depth fields depth_stack [K, H, W].

    Returns [K, H, W, V], or with ``fold`` the ``vweights`` ([H, W, V])
    weighted sum over views [K, H, W]."""
    V, H, W = gctx.src_depths.shape
    K = depth_stack.shape[0]
    if tuple(depth_stack.shape[1:]) != (H, W):
        raise ValueError("geom_cost: depth_stack must be [K, H, W] at the "
                         "source depth resolution")
    if fold and (vweights is None or tuple(vweights.shape) != (H, W, V)):
        raise ValueError("geom_cost: fold needs vweights [H, W, V]")
    if depth_stack.device.type == "cpu":
        return geom_cost_plain(gctx, depth_stack, vweights, fold)
    if depth_stack.device.type != "cuda":
        raise ValueError(f"geom_cost: unsupported device "
                         f"{depth_stack.device}")

    ref = _cam_rows(gctx.ref_K, gctx.ref_R, gctx.ref_t, gctx.ref_c)
    srcs = _cam_rows(gctx.src_K, gctx.src_R, gctx.src_t, gctx.src_c)
    depths = depth_stack.contiguous()
    vw = torch.movedim(vweights, -1, 0).contiguous() if fold else None
    _build.require_cuda_inputs(_NAME, [depths, gctx.src_depths, ref, srcs,
                                       vw], depths.device)
    shape = (K, H, W) if fold else (K, H, W, V)
    out = torch.empty(shape, dtype=torch.float32, device=depths.device)
    fn = _build.library(_NAME).launch_geom
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    P = _build.ptr
    err = fn(P(depths), P(gctx.src_depths), P(ref), P(srcs), P(vw), P(out),
             K, V, H, W, ctypes.c_void_p(_build.stream_ptr(depths)))
    _build.check(err, _NAME)
    return out
