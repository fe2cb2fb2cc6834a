"""Disparity sweeps: weak/strong reclassification and local refine
(counterpart of ``dvpmvs/kernels/sweep.py``).

Oracles: ``DepthToWeak`` (APD.cu:3892-4051): per pixel, sweep +-30
disparity steps of the view-weighted NCC(+geom) cost around the current
depth and classify WEAK / STRONG / UNKNOWN from the peak structure;
``LocalRefine`` (APD.cu:4053-4139): +-5 disparity polish, adopting the best
depth if it improves the cost by > 0.1.

The fused backend sweeps a pass without a radius map through the sweep
kernel (K2) with the geom kernel (K3) folding the geometric term; otherwise
(the exact and warp backends, or a radius map) the constant-plane sweep
``_sweep_costs`` evaluates candidate chunks through ``ncc_cost_batch``, with
the geom term from K3's per-view mode for every backend.

With ``rows`` (an ``engine.rows.RowWindow`` of the tiled pass) both sweeps
score the window's compute rows against whole per-pixel inputs and return
the compute rows' result; the caller exchanges the owned rows.
"""

from __future__ import annotations

import torch

from .. import fmath
from ..config import PixelState
from ..geometry.camera import Camera
from .gatherfree import take0
from .geom_fused import geom_cost
from .ncc import COST_MAX, CostContext, ncc_cost_batch
from .sampling import plane_from_normal_depth


def _field_sweep_eligible(ctx: CostContext) -> bool:
    """The sweep kernel serves fused contexts with a static window."""
    return ctx.backend == "fused" and not ctx.has_radius_map


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


def _take(rows):
    return (lambda a: a) if rows is None else rows.take


def _field_sweep_costs(ctx: CostContext, gctx, geom_factor, depth, baseline,
                       k0: int, K: int, sel_views, view_weights,
                       ref_cam: Camera, depth_min, depth_max, rows=None):
    """[K, H, W] sweep costs via the sweep kernel (steps k - k0 around the
    per-pixel disparity of ``depth``); weighting, in-range and no-view
    masking match ``_sweep_costs``.  ``depth`` and ``baseline`` are whole;
    the result is on the compute rows of ``rows``."""
    from .sweep_fused import sweep_weighted_from_ctx

    take = _take(rows)
    fx = ref_cam.fx
    w = take(view_weights) * take(sel_views).to(torch.float32)
    norm = torch.sum(w, dim=-1)
    wsum = sweep_weighted_from_ctx(ctx, depth, baseline, fx, w, K=K, k0=k0)

    depth, baseline = take(depth), take(baseline)
    disp = fx * baseline / torch.clamp(depth, min=1e-12)
    ks = torch.arange(K, dtype=torch.float32, device=depth.device) - k0
    depth_stack = fx * baseline / (disp[None] + ks[:, None, None])
    if gctx is not None:
        gw = geom_cost(gctx, depth_stack, vweights=w, fold=True, y0=ctx.y0)
        wsum = wsum + geom_factor * gw
    cost = wsum / torch.clamp(norm, min=1e-30)[None]
    in_range = (depth_stack >= depth_min) & (depth_stack <= depth_max)
    return torch.where(in_range & (norm > 0)[None], cost, _full(cost,
                                                                  COST_MAX))


def _mean_selected_baseline(sel_views, ref_cam: Camera, src_cams: Camera):
    """Per-pixel mean ||C_ref - C_src|| over selected views -> [H, W]."""
    bl = fmath.norm(ref_cam.c[None, :] - src_cams.c, dim=-1)  # [V]
    sel = sel_views.to(torch.float32)
    cnt = torch.sum(sel, dim=-1)
    tot = torch.sum(sel * bl[None, None, :], dim=-1)
    return (torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0),
                        torch.zeros_like(tot)), cnt)


def _sweep_costs(ctx: CostContext, gctx, geom_factor, normal, depth_stack,
                 sel_views, view_weights, xs, ys, ref_cam, depth_min,
                 depth_max, chunk: int = 8):
    """Costs of K candidate depth fields [K, H, W] -> [K, H, W] under the
    pixel's normal (constant-plane window), in chunks of ``chunk``."""
    K = depth_stack.shape[0]
    w = view_weights * sel_views.to(torch.float32)
    norm = torch.sum(w, dim=-1)
    outs = []
    for k0 in range(0, K, chunk):
        d = depth_stack[k0:k0 + chunk]
        planes = torch.stack([plane_from_normal_depth(normal, dd, xs, ys,
                                                      ref_cam) for dd in d])
        cv = ncc_cost_batch(ctx, planes)                       # [k,H,W,V]
        if gctx is not None:
            cv = cv + geom_factor * geom_cost(gctx, d.contiguous(),
                                              y0=ctx.y0)
        cost = torch.sum(cv * w[None], dim=-1) / torch.clamp(norm, min=1e-30)
        in_range = (d >= depth_min) & (d <= depth_max)
        outs.append(torch.where(in_range & (norm > 0), cost,
                                _full(cost, COST_MAX)))
    return torch.cat(outs, dim=0)


def depth_to_weak(ctx: CostContext, gctx, geom_factor, normal, depth,
                  sel_views, view_weights, xs, ys, ref_cam: Camera,
                  src_cams: Camera, depth_min, depth_max, weak_peak_radius,
                  radius_steps: int = 30, return_curve: bool = False,
                  rows=None) -> torch.Tensor:
    """Reclassify pixels -> int8 [H, W] of PixelState.

    ``return_curve`` also returns the [2*radius_steps+1, H, W] sweep cost
    curves (the reference's DEBUG_COST_LINE buffer, APD.cu:3990-3997)."""
    take = _take(rows)
    baseline, nsel = _mean_selected_baseline(sel_views, ref_cam, src_cams)
    fx = ref_cam.fx
    if _field_sweep_eligible(ctx):
        p_costs = _field_sweep_costs(
            ctx, gctx, geom_factor, depth, baseline, radius_steps,
            2 * radius_steps + 1, sel_views, view_weights, ref_cam,
            depth_min, depth_max, rows)                        # [61, H, W]
        depth, nsel = take(depth), take(nsel)
    else:
        depth, nsel, baseline = take(depth), take(nsel), take(baseline)
        disp = fx * baseline / torch.clamp(depth, min=1e-12)
        ks = torch.arange(-radius_steps, radius_steps + 1,
                          dtype=torch.float32, device=depth.device)
        depth_stack = fx * baseline / (disp[None] + ks[:, None, None])
        p_costs = _sweep_costs(ctx, gctx, geom_factor, take(normal),
                               depth_stack, take(sel_views),
                               take(view_weights), take(xs), take(ys),
                               ref_cam, depth_min, depth_max)
    p_costs = torch.clamp(p_costs, max=COST_MAX)
    weak = classify_from_sweep(p_costs, depth, nsel, radius_steps,
                               weak_peak_radius, rows)
    return (weak, p_costs) if return_curve else weak


def classify_from_sweep(p_costs, depth, nsel, radius_steps: int,
                        weak_peak_radius, rows=None) -> torch.Tensor:
    """Peak-structure classification of sweep cost curves [K, H, W] (on the
    compute rows of ``rows``: the border margin is the image's)."""
    H, W = depth.shape
    dev = depth.device
    min_margin = 6
    # local minima ("peaks") over i in [2, 58] (APD.cu:4007-4016)
    interior = torch.zeros(p_costs.shape, dtype=torch.bool, device=dev)
    interior[1:-1] = ((p_costs[1:-1] < p_costs[:-2])
                      & (p_costs[1:-1] < p_costs[2:]))
    idx = torch.arange(p_costs.shape[0], device=dev)[:, None, None]
    interior = interior & (idx >= 2) & (idx <= 2 * radius_steps - 2)

    peak_count = torch.sum(interior, dim=0)
    masked = torch.where(interior, p_costs, _full(p_costs, float("inf")))
    min_cost = torch.min(masked, dim=0).values
    min_peak = torch.argmin(masked, dim=0)
    has_peak = peak_count > 0
    min_cost = torch.where(has_peak, min_cost, _full(min_cost, COST_MAX))
    min_peak = torch.where(has_peak, min_peak, torch.zeros_like(min_peak))

    # classification cascade (APD.cu:4020-4050)
    off_center = ((torch.abs(min_peak - radius_steps) > weak_peak_radius)
                  | (min_cost > 0.5))
    single = peak_count == 1
    single_strong = min_cost <= 0.15
    others = interior & (idx != min_peak[None])
    var = fmath.sqrt(torch.sum(
        torch.where(others, (p_costs - min_cost) ** 2,
                    torch.zeros_like(p_costs)), dim=0))
    var = var / torch.clamp(peak_count - 1, min=1)
    multi_strong = var > 0.2

    weak_v, strong_v = int(PixelState.WEAK), int(PixelState.STRONG)
    cls = torch.where(
        off_center, weak_v,
        torch.where(single,
                    torch.where(single_strong, strong_v, weak_v),
                    torch.where(multi_strong, strong_v, weak_v)))
    ysg = torch.arange(H, device=dev)[:, None]
    if rows is not None:
        H, ysg = rows.H, rows.row_ids(dev)[:, None]
    xsg = torch.arange(W, device=dev)[None, :]
    border = ((xsg < min_margin) | (ysg < min_margin)
              | (xsg >= W - min_margin) | (ysg >= H - min_margin))
    unknown = border | (depth == 0) | (nsel == 0)
    return torch.where(unknown, int(PixelState.UNKNOWN), cls).to(torch.int8)


def local_refine(ctx: CostContext, gctx, geom_factor, normal, depth,
                 sel_views, view_weights, xs, ys, ref_cam: Camera,
                 src_cams: Camera, depth_min, depth_max,
                 radius_steps: int = 5, rows=None) -> torch.Tensor:
    """+-5-disparity polish of the depth map -> refined depth [H, W]."""
    take = _take(rows)
    baseline, nsel = _mean_selected_baseline(sel_views, ref_cam, src_cams)
    fx = ref_cam.fx
    if _field_sweep_eligible(ctx):
        costs = _field_sweep_costs(
            ctx, gctx, geom_factor, depth, baseline, radius_steps,
            2 * radius_steps + 1, sel_views, view_weights, ref_cam,
            depth_min, depth_max, rows)                        # [11, H, W]
        cost_now = costs[radius_steps]
    depth, baseline, nsel = take(depth), take(baseline), take(nsel)
    disp = fx * baseline / torch.clamp(depth, min=1e-12)
    ks = torch.arange(-radius_steps, radius_steps + 1, dtype=torch.float32,
                      device=depth.device)
    depths = fx * baseline / (disp[None] + ks[:, None, None])
    if not _field_sweep_eligible(ctx):
        normal, sel_views, view_weights, xs, ys = (
            take(a) for a in (normal, sel_views, view_weights, xs, ys))
        costs = _sweep_costs(ctx, gctx, geom_factor, normal, depths,
                             sel_views, view_weights, xs, ys, ref_cam,
                             depth_min, depth_max)
        cost_now = _sweep_costs(ctx, gctx, geom_factor, normal, depth[None],
                                sel_views, view_weights, xs, ys, ref_cam,
                                depth_min, depth_max)[0]
    best = torch.argmin(costs, dim=0)
    min_cost = take0(costs, best)
    best_depth = take0(depths, best)
    improve = (cost_now - min_cost > 0.1) & (nsel > 0) & (depth != 0)
    return torch.where(improve, best_depth, depth)
