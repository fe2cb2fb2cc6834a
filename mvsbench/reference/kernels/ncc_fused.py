"""K1: fused multi-plane, multi-view bilateral-NCC cost (counterpart of
``dvpmvs/kernels/ncc_fused.py::fused_ncc_costs``).

``fused_ncc_costs`` evaluates B candidate plane fields against V source
views in one launch of ``csrc/ncc_fused.cu`` for tensors on the card, or in
``fused_ncc_costs_plain`` (the same function in plain PyTorch, taps and
views as tensor dims, one plane at a time) for tensors on the CPU.

A plane enters as (n, w), and the warp terms are formed exactly as
``_ncc_cost_exact`` forms them (s = (n . u) / w).  The TPU kernel takes
q = n / w instead; that rounds differently, and the variance's cancellation
(m2 - m^2 at intensities ~128) turns the difference into ~1e-4 cost
differences on ~0.2 % of entries, where (n, w) reproduces the exact path to
~1e-7.  With ``parity`` 0/1 the per-pixel inputs (planes, tap weights,
moment sums, radius map) live on the checkerboard-packed half grid
(engine/packing.py) and evaluation pixel (y, i) sits at
x = 2 i + (y + parity) % 2; the sources stay full resolution.

The kernel rounds every operation as the plain version does and agrees
with it bitwise (``chip_smoke.py`` holds it to 1e-3 except on 1e-3 of the
entries); its two quotients a tap share one refined reciprocal of hz, which
gives the divides' own bits.  It may not round otherwise: the variance's
cancellation turns a last-bit change in a tap (an FMA, a product with a
plain reciprocal in place of a divide) into cost differences above 1e-3 on
~2 % of the entries at 608 x 800 (``tests/test_torch_kernel_model.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .ncc import (_center_inview, _grid, _ncc_from_moments,
                  _window_moments, plane_warp_fields)

_NAME = "ncc_fused"
MAX_VIEWS = 128     # the (plane, view) costs a block stages per pixel


def eval_coords(Hp: int, Wp: int, parity: Optional[int], device,
                y0: int = 0):
    """Full-resolution (xs, ys) float32 coordinates of the evaluation grid,
    whose first row is image row ``y0``."""
    xs, ys = _grid(Hp, Wp, device)
    if y0:
        ys = ys + float(y0)
    if parity is not None:
        xs = 2.0 * xs + torch.remainder(ys + parity, 2.0)
    return xs, ys


def _mats(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[V, 12] per-view constants: M row-major, then b."""
    return torch.cat([M.reshape(-1, 9), b.reshape(-1, 3)], dim=1).contiguous()


def fused_ncc_costs_plain(planes, w_taps, wref_taps, wsums, src, M, b, cam,
                          src_wh, radius: float = 5.0, radius_map=None,
                          parity=None, y0: int = 0):
    """The plain version of K1: same arguments, same result [B, H', W', V]."""
    B, Hp, Wp, _ = planes.shape
    xs, ys = eval_coords(Hp, Wp, parity, planes.device, y0)
    rx = (xs - cam[0]) / cam[2]
    ry = (ys - cam[1]) / cam[3]
    inv_fx = 1.0 / cam[2]
    inv_fy = 1.0 / cam[3]
    rad = radius_map if radius_map is not None else float(radius)
    inv = 1.0 / torch.clamp(wsums[0], min=1e-30)
    out = []
    for plane in planes:
        base, colx, coly = plane_warp_fields(M, b, plane, rx, ry, inv_fx,
                                             inv_fy)
        in_view = _center_inview(base, src_wh)
        s1, s2, s3 = _window_moments(src, base, colx, coly, rad, w_taps,
                                     wref_taps)
        out.append(_ncc_from_moments(inv, wsums[1], wsums[2], s1, s2, s3,
                                     in_view))
    return torch.stack(out)


def fused_ncc_costs(planes, w_taps, wref_taps, wsums, src, M, b, cam, src_wh,
                    radius: float = 5.0, radius_map=None, parity=None,
                    y0: int = 0):
    """B plane fields x V views -> costs [B, H', W', V].

    planes [B, H', W', 4] (n, w); w_taps, wref_taps [36, H', W']; wsums
    [3, H', W'] (sum_w, sum_wref, sum_wref2); src [V, H, W] fp32; M [V, 3, 3]; b [V, 3];
    cam [4] (cx, cy, fx, fy of the reference); src_wh [V, 2]; radius the
    static window radius, or radius_map [H', W'] per pixel; parity None for
    the dense grid or 0/1 for a checkerboard-packed one; y0 the image row of
    the evaluation grid's first row (a row window: H' rows from y0)."""
    B, Hp, Wp, four = planes.shape
    V, H, W = src.shape
    if four != 4 or w_taps.shape != (36, Hp, Wp) or \
            wref_taps.shape != (36, Hp, Wp) or wsums.shape != (3, Hp, Wp):
        raise ValueError("fused_ncc_costs: inconsistent shapes "
                         f"planes {tuple(planes.shape)} w_taps "
                         f"{tuple(w_taps.shape)} wsums {tuple(wsums.shape)}")
    if radius_map is not None and radius_map.shape != (Hp, Wp):
        raise ValueError("fused_ncc_costs: radius_map must be [H', W']")
    if parity not in (None, 0, 1):
        raise ValueError("fused_ncc_costs: parity must be None, 0 or 1")
    if not 0 <= y0 <= H - Hp:
        raise ValueError(f"fused_ncc_costs: rows [{y0}, {y0 + Hp}) outside "
                         f"an image of {H} rows")
    return fused_ncc_costs_plain(planes, w_taps, wref_taps, wsums, src,
                                 M, b, cam, src_wh, radius, radius_map,
                                 parity, y0)


def fused_cost_from_ctx(ctx, planes: torch.Tensor, parity=None
                        ) -> torch.Tensor:
    """ncc_cost_batch entry: planes [B, H', W', 4] -> costs [B, H', W', V]
    (dense, or checkerboard-packed when ``parity`` is 0/1 — then the weight
    fields of ``ctx`` must already be packed, see engine/packing.py); the
    evaluation rows start at the context's image row ``ctx.y0``."""
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    return fused_ncc_costs(
        planes.contiguous(), ctx.w_taps.contiguous(),
        ctx.wref_taps.contiguous(), wsums, ctx.src_imgs, ctx.M, ctx.b,
        ctx.cam, ctx.src_wh, radius=float(ctx.strong_radius),
        radius_map=ctx.radius.contiguous() if ctx.has_radius_map else None,
        parity=parity, y0=ctx.y0)
