"""Checkerboard (red-black) packing helpers (counterpart of
``dvpmvs/engine/packing.py``).

A pixel of color ``c`` sits at x = 2*i + (y + c) % 2.  Packing a [H, W]
field to [H, ceil(W/2)] keeps only the active color's pixels, so candidate
costs, MHJVS and refinement run on half the data.  ``axis`` names the H axis
of the field (W follows it); trailing dims ride along.  ``row0`` is the
image row of the field's first row (a row window of the tiled pass may
start on an odd row).
"""

from __future__ import annotations

import torch


def _row_parity(arr: torch.Tensor, color: int, axis: int,
                row0: int = 0) -> torch.Tensor:
    H = arr.shape[axis]
    par = (torch.arange(H, device=arr.device) + row0 + color) % 2
    return par.reshape((1,) * axis + (H, 1) + (1,) * (arr.dim() - axis - 2))


def pack_parity(arr: torch.Tensor, color: int, axis: int = 0,
                row0: int = 0) -> torch.Tensor:
    """[.., H, W, ...] -> [.., H, ceil(W/2), ...]: keep pixels with
    (x + y + color) % 2 == 0, i.e. x = 2*i + (y + color) % 2, for image
    rows y = row0 + local row."""
    W = arr.shape[axis + 1]
    if W % 2:
        arr = torch.cat([arr, arr.narrow(axis + 1, W - 1, 1)], dim=axis + 1)
    idx = [slice(None)] * arr.dim()
    idx[axis + 1] = slice(0, None, 2)
    a0 = arr[tuple(idx)]
    idx[axis + 1] = slice(1, None, 2)
    a1 = arr[tuple(idx)]
    return torch.where(_row_parity(a0, color, axis, row0) == 0, a0, a1)


def unpack_parity(packed: torch.Tensor, color: int, other: torch.Tensor,
                  row0: int = 0) -> torch.Tensor:
    """Scatter a packed field back: active-color pixels take ``packed``,
    the rest keep ``other`` ([H, W, ...], image rows from ``row0``)."""
    H, W = other.shape[0], other.shape[1]
    expanded = torch.repeat_interleave(packed, 2, dim=1)[:, :W]
    ys = torch.arange(H, device=other.device)[:, None] + row0
    xs = torch.arange(W, device=other.device)[None, :]
    active = (xs + ys + color) % 2 == 0
    active = active.reshape((H, W) + (1,) * (other.dim() - 2))
    return torch.where(active, expanded, other)


def pack_ctx(ctx, color: int):
    """CostContext view with its per-pixel fields checkerboard-packed (at
    the context's row origin ``ctx.y0``).

    The fields the NCC kernel reads per evaluation pixel are packed; the
    sources stay full resolution (samples are full-res coordinates)."""
    pk = lambda a: pack_parity(a, color, row0=ctx.y0).contiguous()
    pk_t = lambda a: pack_parity(a, color, axis=1, row0=ctx.y0).contiguous()
    return ctx.replace(
        rx=pk(ctx.rx), ry=pk(ctx.ry),
        w_taps=pk_t(ctx.w_taps),
        wref_taps=pk_t(ctx.wref_taps),
        sum_w=pk(ctx.sum_w),
        sum_wref=pk(ctx.sum_wref),
        sum_wref2=pk(ctx.sum_wref2),
        radius=pk(ctx.radius),
    )
