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

import dataclasses
from typing import Optional

import torch

from .geom import GeomContext, geom_consistency_cost
from .ncc_fused import eval_coords

_NAME = "geom"


def parity_context(gctx: GeomContext, parity: int, y0: int = 0,
                   Hp: int = 0) -> GeomContext:
    """``gctx`` with its per-pixel coordinate fields on one checkerboard
    color (x = 2 i + (y + parity) % 2, computed, not packed, so that the
    padding column of an odd width sits at x = W as in the kernel), for
    the Hp image rows from ``y0`` (all of them by default)."""
    H, W = gctx.xs.shape
    xs, ys = eval_coords(Hp or H, (W + 1) // 2, parity, gctx.xs.device, y0)
    ref_K = gctx.ref_K
    return dataclasses.replace(gctx, xs=xs, ys=ys,
                               rx=(xs - ref_K[0, 2]) / ref_K[0, 0],
                               ry=(ys - ref_K[1, 2]) / ref_K[1, 1])


def row_context(gctx: GeomContext, y0: int, Hp: int) -> GeomContext:
    """``gctx`` with its per-pixel coordinate fields on the image rows
    (y0 + j) mod H, j < Hp."""
    H = gctx.xs.shape[0]
    if y0 == 0 and Hp == H:
        return gctx
    rows = torch.remainder(torch.arange(y0, y0 + Hp, device=gctx.xs.device),
                           H)
    take = lambda a: a.index_select(0, rows)
    return dataclasses.replace(gctx, xs=take(gctx.xs), ys=take(gctx.ys),
                               rx=take(gctx.rx), ry=take(gctx.ry))


def geom_cost_plain(gctx: GeomContext, depth_stack: torch.Tensor,
                    vweights: Optional[torch.Tensor] = None,
                    fold: bool = False, chunk: int = 8,
                    parity: Optional[int] = None, y0: int = 0
                    ) -> torch.Tensor:
    """The plain version of K3: same arguments, same result."""
    Hp = depth_stack.shape[1]
    if parity is not None:
        gctx = parity_context(gctx, parity, y0, Hp)
    else:
        gctx = row_context(gctx, y0, Hp)
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
              fold: bool = False, parity: Optional[int] = None,
              y0: int = 0) -> torch.Tensor:
    """Geom costs of K candidate depth fields depth_stack [K, H', W'].

    Returns [K, H', W', V], or with ``fold`` the ``vweights`` ([H', W, V])
    weighted sum over views [K, H', W].  W' is W, or ceil(W/2) with
    ``parity`` 0/1 (one checkerboard color; per view only).  The H' rows
    are image rows (y0 + j) mod H: the whole image by default, a row window
    of the tiled pass otherwise."""
    V, H, W = gctx.src_depths.shape
    K, Hp = depth_stack.shape[:2]
    if parity not in (None, 0, 1):
        raise ValueError("geom_cost: parity must be None, 0 or 1")
    if parity is not None and fold:
        raise ValueError("geom_cost: the parity mode is per view only")
    Wp = W if parity is None else (W + 1) // 2
    if depth_stack.shape[2] != Wp or Hp > H or not -H < y0 < H:
        raise ValueError(f"geom_cost: depth_stack must be [K, <= {H}, "
                         f"{Wp}] with y0 in ({-H}, {H}), got "
                         f"{tuple(depth_stack.shape)} and {y0}")
    if fold and (vweights is None or tuple(vweights.shape) != (Hp, W, V)):
        raise ValueError("geom_cost: fold needs vweights [H', W, V]")
    return geom_cost_plain(gctx, depth_stack, vweights, fold,
                           parity=parity, y0=y0)


