"""The per-view PatchMatch pass (counterpart of
``dvpmvs/engine/patchmatch.py``), for the passes of round 0: FIRST_INIT and
REFINE_ITER with ``use_APD=False``.

    init (random init + top-k initial cost, or the previous pass's planes)
    for iter in range(max_iterations):
        for color in (black, red):
            strong propagation -> MHJVS -> adoption -> 6-plane refinement
    plane -> (depth, world normal);  checkerboard median filter
    DepthToWeak reclassification;  LocalRefine polish

Each half-iteration computes proposals on the checkerboard-packed half grid
(fused backend) or the full grid (exact backend) and commits only its color.
Random draws come from a draw source (``rng.py``) at the full-grid shapes
of JAX's exact path, under the JAX key paths of the same sites.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..config import PMDynamic, PMStatic, PixelState, RunState
from ..geometry.camera import Camera
from ..geometry.transforms import depth_from_plane, plane_from_world
from ..kernels.gatherfree import take0
from ..kernels.geom import build_geom_context
from ..kernels.median import median_filter_depth
from ..kernels.ncc import (COST_MAX, CostContext, _grid, build_cost_context,
                           ncc_cost, ncc_cost_batch)
from ..kernels.propagation import (edge_candidate_merge, judge_extend, mhjvs,
                                   neighbor_prior, select_candidates,
                                   select_candidates_edge, weighted_cost)
from ..kernels.refine import refinement_planes
from ..kernels.sampling import (identity_pack, plane_from_normal_depth,
                                random_depth, visibility_prior_normal)
from ..kernels.sweep import depth_to_weak, local_refine
from ..kernels.weak import edge_ray_distance
from ..rng import DrawSource, fold_in, split
from .packing import pack_ctx, pack_parity, unpack_parity
from .state import PassOutput, PMState


def _ray(rx, ry):
    r = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    return r / torch.linalg.norm(r, dim=-1, keepdim=True)


def _initial_cost_first(ctx: CostContext, plane, top_k: int):
    """ComputeMultiViewInitialCostandSelectedViews (APD.cu:1115-1161):
    mean of the top-k view costs and the selected-view set."""
    costs = ncc_cost(ctx, plane)                       # [H, W, V]
    V = costs.shape[-1]
    num_valid = torch.sum(costs < COST_MAX, dim=-1)
    k = torch.clamp(num_valid, max=top_k)
    work = costs
    total = torch.zeros(costs.shape[:2], device=costs.device)
    thresh = torch.full(costs.shape[:2], COST_MAX, device=costs.device)
    ar = torch.arange(V, device=costs.device)
    for i in range(top_k):
        m = torch.min(work, dim=-1).values
        total = total + torch.where(i < k, m, torch.zeros_like(m))
        thresh = torch.where(i == k - 1, m, thresh)
        hit = ar == torch.argmin(work, dim=-1)[..., None]
        work = torch.where(hit, torch.full_like(work, float("inf")), work)
    mean_topk = total / torch.clamp(k, min=1)
    sel = (costs <= thresh[..., None]) & (k[..., None] > 0)
    cost = torch.where(k > 0, mean_topk, torch.full_like(mean_topk, COST_MAX))
    return cost, sel


def _initial_cost_refine(ctx: CostContext, plane, sel_views):
    """ComputeMultiViewInitialCost (APD.cu:1163-1191): mean over selected
    views with cost < max; failing views are unselected."""
    costs = ncc_cost(ctx, plane)
    ok = sel_views & (costs < COST_MAX)
    cnt = torch.sum(ok, dim=-1)
    cost = torch.sum(torch.where(ok, costs, torch.zeros_like(costs)),
                     dim=-1) / torch.clamp(cnt, min=1)
    return torch.where(cnt > 0, cost, torch.full_like(cost, COST_MAX)), ok


def _propagate_color_strong(state: PMState, color: int, it: int, path_it,
                            draws: DrawSource, ctx, ctx_pk, ref_cam,
                            src_cams, static: PMStatic, dyn: PMDynamic, xs,
                            ys, rx, ry, ray, parity, edge=None,
                            edge_dist=None) -> PMState:
    """One strong half-iteration (one checkerboard color)."""
    path_c = fold_in(path_it, color)
    p_view, p_refine = split(path_c, 2, 0), split(path_c, 2, 1)
    H, W = state.cost.shape
    use_pk = ctx_pk is not None
    if use_pk:
        pk1 = lambda a, axis=0: pack_parity(a, color, axis)
    else:
        pk1 = identity_pack
    pk = lambda a: pk1(a, 0)
    par = color if use_pk else None
    ctx_c = ctx_pk if use_pk else ctx

    if static.use_edge and edge is not None and edge_dist is not None:
        # edge-adaptive dual scan: adaptive + short-range candidates, then
        # the good/bad view-count comparison on their NCC vectors
        (cand1_f, flags1_f, cand2_f, flags2_f,
         differs_f) = select_candidates_edge(state.plane, state.cost, edge,
                                             edge_dist)
        prior = pk(neighbor_prior(state.sel_views, flags1_f))
        cand1, cand2 = pk1(cand1_f, 1), pk1(cand2_f, 1)
        flags1, flags2 = pk1(flags1_f, 1), pk1(flags2_f, 1)
        differs = pk1(differs_f, 1)
        # one 17-plane batch: adaptive(8) + short(8) + current(1)
        cost_all = ncc_cost_batch(
            ctx_c, torch.cat([cand1, cand2, pk(state.plane)[None]]),
            parity=par)
        cost_array, cand_planes, flags = edge_candidate_merge(
            pk(edge), flags1, flags2, differs, cost_all[:8],
            cost_all[8:16], cand1, cand2, it)
        cur_vec = cost_all[16]
    else:
        cand_f, flags_f, mapc_f = select_candidates(state.plane, state.cost,
                                                    ray)
        prior = pk(neighbor_prior(state.sel_views, flags_f))
        cand_planes, flags = pk1(cand_f, 1), pk1(flags_f, 1)
        cost_all = ncc_cost_batch(
            ctx_c, torch.cat([cand_planes, pk(state.plane)[None]]),
            parity=par)
        cost_array = cost_all[:8]
        cur_vec = cost_all[8]
        if static.extend_rounds > 0:
            # extended far propagation (APD.cu:1385-1895): strict-<
            # replacement, fresh NCC for the replaced candidates
            mapc = pk1(mapc_f, 1)
            active = flags
            for e in range(min(static.extend_rounds, 3)):
                active = judge_extend(it, e, cost_array, active)
                ext_f, ext_ok_f, ext_map_f = select_candidates(
                    state.plane, state.cost, ray, extend_round=e)
                ext_p = pk1(ext_f, 1)
                ext_ok = pk1(ext_ok_f, 1)
                ext_map = pk1(ext_map_f, 1)
                rep = active & ext_ok & (ext_map < mapc)
                cand_planes = torch.where(rep[..., None], ext_p, cand_planes)
                mapc = torch.where(rep, ext_map, mapc)
                ca_new = ncc_cost_batch(ctx_c, cand_planes, parity=par)
                cost_array = torch.where(rep[..., None], ca_new, cost_array)

    r = pk1(draws.uniform(p_view, (static.view_samples, H, W, 1)), 1)
    view_weights, temp_sel, weight_norm = mhjvs(r, cost_array, flags, prior,
                                                it)
    final_costs = weighted_cost(cost_array, view_weights[None],
                                weight_norm[None])          # [8, H', W']
    cost0 = weighted_cost(cur_vec, view_weights, weight_norm)

    xs_c, ys_c, rx_c, ry_c = pk(xs), pk(ys), pk(rx), pk(ry)

    # adopt the best direction candidate (APD.cu:2544-2567)
    min_idx = torch.argmin(final_costs, dim=0)
    best_cost = take0(final_costs, min_idx)
    best_plane = take0(cand_planes, min_idx)
    best_flag = take0(flags, min_idx)
    depth_before = depth_from_plane(best_plane, xs_c, ys_c, ref_cam)
    adopt = (best_flag & (depth_before >= dyn.depth_min)
             & (depth_before <= dyn.depth_max) & (best_cost < cost0))

    plane_cur = pk(state.plane)
    sel_cur = pk(state.sel_views)
    plane_now = torch.where(adopt[..., None], best_plane, plane_cur)
    cost_now = torch.where(adopt, best_cost, cost0)
    sel_now = torch.where(adopt[..., None], temp_sel, sel_cur)

    # 6-plane refinement (APD.cu:1311-1383), weighted by the MC view weights
    cur_depth = depth_from_plane(plane_now, xs_c, ys_c, ref_cam)
    ref_planes = refinement_planes(
        draws, p_refine, plane_now[..., :3], cur_depth, sel_now, rx_c, ry_c,
        xs_c, ys_c, ref_cam, src_cams, dyn.depth_min, dyn.depth_max,
        full_hw=(H, W), pk=pk1)
    ref_costs_v = ncc_cost_batch(ctx_c, ref_planes, parity=par)
    ref_costs = weighted_cost(ref_costs_v, view_weights[None],
                              weight_norm[None])            # [6, H', W']
    ref_depths = depth_from_plane(ref_planes, xs_c, ys_c, ref_cam)
    ref_ok = (ref_depths >= dyn.depth_min) & (ref_depths <= dyn.depth_max)
    ref_costs = torch.where(ref_ok, ref_costs,
                            torch.full_like(ref_costs, float("inf")))
    rmin = torch.argmin(ref_costs, dim=0)
    rcost = take0(ref_costs, rmin)
    rplane = take0(ref_planes, rmin)
    take_ref = rcost < cost_now
    plane_now = torch.where(take_ref[..., None], rplane, plane_now)
    cost_now = torch.where(take_ref, rcost, cost_now)

    # writeback gate (APD.cu:2727-2736)
    if static.state == RunState.REFINE_INIT:
        improved = cost_now < cost0 - 0.1
        plane_new = torch.where(improved[..., None], plane_now, plane_cur)
        cost_new = torch.where(improved, cost_now, cost0)
    else:
        plane_new = plane_now
        cost_new = cost_now

    if use_pk:
        plane_new = unpack_parity(plane_new, color, state.plane)
        cost_new = unpack_parity(cost_new, color, state.cost)
        sel_now = unpack_parity(sel_now, color, state.sel_views)
        view_weights = unpack_parity(view_weights, color,
                                     state.view_weights)

    mask = (parity == color) & (state.weak != PixelState.WEAK)
    m1 = mask[..., None]
    return state.replace(
        plane=torch.where(m1, plane_new, state.plane),
        cost=torch.where(mask, cost_new, state.cost),
        sel_views=torch.where(m1, sel_now, state.sel_views),
        view_weights=torch.where(m1, view_weights, state.view_weights),
    )


def run_pass(
    ref_img,                       # [H, W] grayscale 0..255
    src_imgs,                      # [V, H, W]
    ref_cam: Camera,
    src_cams: Camera,              # leading [V]
    static: PMStatic,
    dyn: PMDynamic,
    draws: DrawSource,
    init_plane_world=None,         # [H, W, 4] (n_world, depth)
    init_sel_views=None,           # [H, W, V] bool
    init_weak=None,                # [H, W] int8
    src_depths=None,               # [V, H, W] for geom
    radius_map=None,               # [H, W]
    edge=None,                     # [H, W] edge mask
    device=None,
) -> PassOutput:
    """Run one PatchMatch pass for a reference view on ``device`` (the card
    unless the caller asks for the CPU).  ``draws`` returns its numbers on
    that device."""
    if static.use_APD:
        raise NotImplementedError(
            "use_APD (the weak-pixel machinery of rounds >= 1) belongs to "
            "the APD slice of the port")
    if static.debug_dumps:
        raise NotImplementedError("debug dumps belong to a later slice")
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    ref_img = f32(ref_img)
    src_imgs = f32(src_imgs).contiguous()
    ref_cam, src_cams = ref_cam.to(dev), src_cams.to(dev)

    H, W = ref_img.shape
    V = src_imgs.shape[0]
    xs, ys = _grid(H, W, dev)
    rx = (xs - ref_cam.cx) / ref_cam.fx
    ry = (ys - ref_cam.cy) / ref_cam.fy
    ray = _ray(rx, ry)
    parity = (xs.to(torch.int32) + ys.to(torch.int32)) % 2
    if radius_map is not None:
        radius_map = f32(radius_map)

    ctx = build_cost_context(
        ref_img, src_imgs, ref_cam, src_cams,
        sigma_spatial=dyn.sigma_spatial, sigma_color=dyn.sigma_color,
        radius_map=radius_map if static.use_radius else None,
        strong_radius=static.strong_radius, backend=static.cost_backend)
    # checkerboard-packed context views for the half-iteration batches
    ctx_pks = ((pack_ctx(ctx, 0), pack_ctx(ctx, 1))
               if static.cost_backend == "fused" else (None, None))
    gctx = None
    if static.geom_consistency and src_depths is not None:
        gctx = build_geom_context(f32(src_depths), ref_cam, src_cams)

    if init_weak is None:
        weak = torch.full((H, W), int(PixelState.STRONG), dtype=torch.int8,
                          device=dev)
    else:
        weak = torch.as_tensor(init_weak, device=dev).to(torch.int8)
    if init_sel_views is None:
        sel_views = torch.zeros((H, W, V), dtype=torch.bool, device=dev)
    else:
        sel_views = torch.as_tensor(init_sel_views, device=dev).to(torch.bool)
    radius = (radius_map if radius_map is not None
              else torch.zeros((H, W), device=dev))

    root = ()
    k_init, k_loop = split(root, 3, 0), split(root, 3, 2)

    # the edge-adaptive strong branch runs whenever an edge map exists
    edge_dist = None
    if static.use_edge and edge is not None:
        edge = torch.as_tensor(edge, device=dev).to(torch.bool)
        edge_dist = edge_ray_distance(edge)

    # ---- initialization (RandomInitialization, APD.cu:1273-1309) ----
    if static.state == RunState.FIRST_INIT:
        rand_d = random_depth(draws, split(k_init, 2, 0), (H, W),
                              dyn.depth_min, dyn.depth_max)
        rand_n = visibility_prior_normal(draws, split(k_init, 2, 1), rand_d,
                                         sel_views, rx, ry, ref_cam,
                                         src_cams)
        plane = plane_from_normal_depth(rand_n, rand_d, xs, ys, ref_cam)
        if init_plane_world is not None:
            init_plane_world = f32(init_plane_world)
            prior_d = init_plane_world[..., 3]
            ok = (prior_d >= dyn.depth_min) & (prior_d <= dyn.depth_max)
            prior_plane = plane_from_world(init_plane_world, xs, ys, ref_cam)
            plane = torch.where(ok[..., None], prior_plane, plane)
        cost, sel_views = _initial_cost_first(ctx, plane, static.top_k)
    else:
        if init_plane_world is None or init_sel_views is None:
            raise ValueError("REFINE passes need init_plane_world and "
                             "init_sel_views")
        plane = plane_from_world(f32(init_plane_world), xs, ys, ref_cam)
        cost, sel_views = _initial_cost_refine(ctx, plane, sel_views)

    state = PMState(plane=plane, cost=cost, sel_views=sel_views,
                    view_weights=torch.zeros((H, W, V), device=dev),
                    weak=weak, radius=radius)

    # ---- checkerboard iterations ----
    for it in range(static.max_iterations):
        path_it = fold_in(k_loop, it)
        for color in (0, 1):
            state = _propagate_color_strong(
                state, color, it, path_it, draws, ctx, ctx_pks[color],
                ref_cam, src_cams, static, dyn, xs, ys, rx, ry, ray, parity,
                edge=edge, edge_dist=edge_dist)

    # ---- post: depth/normal extraction + filters ----
    depth = depth_from_plane(state.plane, xs, ys, ref_cam)
    normal_ref = state.plane[..., :3]
    depth = median_filter_depth(depth, state.weak, state.cost)
    weak_new = depth_to_weak(
        ctx, gctx, dyn.geom_factor, normal_ref, depth, state.sel_views,
        state.view_weights, xs, ys, ref_cam, src_cams,
        dyn.depth_min, dyn.depth_max, dyn.weak_peak_radius)
    depth = local_refine(
        ctx, gctx, dyn.geom_factor, normal_ref, depth, state.sel_views,
        state.view_weights, xs, ys, ref_cam, src_cams,
        dyn.depth_min, dyn.depth_max)

    # host-extraction semantics (main.cpp:300-308): out-of-range -> 0/UNKNOWN
    in_range = (depth >= dyn.depth_min) & (depth <= dyn.depth_max)
    depth = torch.where(in_range, depth, torch.zeros_like(depth))
    weak_new = torch.where(in_range, weak_new,
                           torch.full_like(weak_new, int(PixelState.UNKNOWN)))

    normal_world = torch.einsum("ji,hwj->hwi", ref_cam.R, normal_ref)
    radius_out = torch.where(state.radius == 0,
                             torch.full_like(state.radius,
                                             float(static.strong_radius)),
                             state.radius)
    return PassOutput(depth=depth, normal_world=normal_world,
                      cost=state.cost, weak=weak_new,
                      sel_views=state.sel_views,
                      view_weights=state.view_weights, radius=radius_out)
