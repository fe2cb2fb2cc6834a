"""The per-view PatchMatch pass (counterpart of
``dvpmvs/engine/patchmatch.py``): FIRST_INIT, REFINE_INIT and REFINE_ITER,
with or without the weak-pixel machinery (``use_APD``).

    init (random init + top-k initial cost, or the previous pass's planes)
    [use_APD] detail demotion, complexity, anchor generation + reliability
    for iter in range(max_iterations):
        for color in (black, red):
            strong propagation -> MHJVS -> adoption -> 6-plane refinement
        [use_APD] RANSAC fit planes, then per color:
            weak propagation over the 8 anchor planes (deformable cost,
            geometric consistency) -> fit-plane test -> refinement
    plane -> (depth, world normal);  checkerboard median filter
    DepthToWeak reclassification;  LocalRefine polish

Each half-iteration computes proposals on the checkerboard-packed half grid
(fused backend) or the full grid (exact and warp backends) and commits only
its color.  The weak half computes its anchor term (K4, with the
sparse-patch taps where ``anchor_taps`` > 1) at a compacted band-major list
of the weak pixels of its grid and scatters it over the center-window cost.
Random draws come from a draw source (``rng.py``) at the full-grid shapes
of JAX's exact path, under the JAX key paths of the same sites.

With ``rows`` (``engine/rows.py``, the row-tiled pass of ``dist/tiles.py``)
a rank keeps the whole state and computes the heavy per-pixel stages on its
window of rows (its own rows, plus a halo on the warp backend, whose taps
read the costs of neighbouring rows), reading whole tensors at absolute
coordinates; every stage that commits ends with an exchange of the owned
rows.  The draws are taken at the whole grid and cut to the window, and the
weak compaction ranks the whole grid, so the tiled pass equals the untiled
one bit for bit.  The glue that floods or ranks the whole state
(nearest-strong flooding, the edge and label distances, the patch
candidates read at anchors anywhere, the compaction's rank) runs whole on
every rank and gives every rank the same bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import fmath
from .. import resolve_device
from ..config import PMDynamic, PMStatic, PixelState, RunState
from ..geometry.camera import Camera
from ..geometry.transforms import depth_from_plane, plane_from_world
from ..kernels.anchor_fused import anchor_slot_costs_from_ctx
from ..kernels.deformable import (anchor_fields_at, deformable_cost_exact,
                                  gather_tap_words, pack_tap_fields)
from ..kernels.gatherfree import take0
from ..kernels.geom import build_geom_context
from ..kernels.geom_fused import geom_cost
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
from ..kernels.weak import (AnchorResult, demote_detail, edge_complexity,
                            edge_ray_distance, find_anchors,
                            label_boundary_distance, patch_candidates,
                            ransac_fit_plane)
from ..kernels.warp_fused import tap_shifts
from ..rng import DrawSource, fold_in, split
from .packing import pack_ctx, pack_parity, unpack_parity
from .rows import Rows, RowWindow
from .state import PassOutput, PMState


def _ray(rx, ry):
    r = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    return r / fmath.norm(r, dim=-1, keepdim=True)


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


def _packers(win: RowWindow, color: int, use_pk: bool):
    """(pkw, pkc): the evaluation grid of a whole tensor (its compute rows,
    checkerboard-packed to ``color`` where ``use_pk``) and of a tensor
    already on the compute rows."""
    if use_pk:
        pkc = lambda a, axis=0: pack_parity(a, color, axis, row0=win.c0)
    else:
        pkc = identity_pack
    return (lambda a, axis=0: pkc(win.take(a, axis), axis)), pkc


def _commit(state: PMState, win: RowWindow, mask, plane, cost, sel, vw,
            use_pk: bool, color: int) -> PMState:
    """The half-iteration's results (on its evaluation grid) committed where
    ``mask`` (compute rows) holds, then made whole by the exchange."""
    cur = [win.take(t) for t in (state.plane, state.cost, state.sel_views,
                                 state.view_weights)]
    new = [plane, cost, sel, vw]
    if use_pk:
        new = [unpack_parity(n, color, c, win.c0) for n, c in zip(new, cur)]
    m1 = mask[..., None]
    out = [win.commit(torch.where(m, n, c))
           for m, n, c in zip((m1, mask, m1, m1), new, cur)]
    return state.replace(plane=out[0], cost=out[1], sel_views=out[2],
                         view_weights=out[3])


def _propagate_color_strong(state: PMState, color: int, it: int, path_it,
                            draws: DrawSource, ctx, ctx_pk, ref_cam,
                            src_cams, static: PMStatic, dyn: PMDynamic, xs,
                            ys, rx, ry, ray, parity, edge=None,
                            edge_dist=None, win: Optional[RowWindow] = None
                            ) -> PMState:
    """One strong half-iteration (one checkerboard color), computed on the
    window's compute rows."""
    path_c = fold_in(path_it, color)
    p_view, p_refine = split(path_c, 2, 0), split(path_c, 2, 1)
    H, W = state.cost.shape
    win = win or RowWindow.whole(H)
    rows = None if win.is_whole else win
    use_pk = ctx_pk is not None
    pk1, pkc = _packers(win, color, use_pk)
    pk = lambda a: pk1(a, 0)
    par = color if use_pk else None
    ctx_c = ctx_pk if use_pk else ctx

    if static.use_edge and edge is not None and edge_dist is not None:
        # edge-adaptive dual scan: adaptive + short-range candidates, then
        # the good/bad view-count comparison on their NCC vectors
        (cand1_f, flags1_f, cand2_f, flags2_f,
         differs_f) = select_candidates_edge(state.plane, state.cost, edge,
                                             edge_dist, rows=rows)
        prior = pkc(neighbor_prior(state.sel_views, flags1_f, rows))
        cand1, cand2 = pkc(cand1_f, 1), pkc(cand2_f, 1)
        flags1, flags2 = pkc(flags1_f, 1), pkc(flags2_f, 1)
        differs = pkc(differs_f, 1)
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
                                                    ray, rows=rows)
        prior = pkc(neighbor_prior(state.sel_views, flags_f, rows))
        cand_planes, flags = pkc(cand_f, 1), pkc(flags_f, 1)
        cost_all = ncc_cost_batch(
            ctx_c, torch.cat([cand_planes, pk(state.plane)[None]]),
            parity=par)
        cost_array = cost_all[:8]
        cur_vec = cost_all[8]
        if static.extend_rounds > 0:
            # extended far propagation (APD.cu:1385-1895): strict-<
            # replacement, fresh NCC for the replaced candidates
            mapc = pkc(mapc_f, 1)
            active = flags
            for e in range(min(static.extend_rounds, 3)):
                active = judge_extend(it, e, cost_array, active)
                ext_f, ext_ok_f, ext_map_f = select_candidates(
                    state.plane, state.cost, ray, extend_round=e, rows=rows)
                ext_p = pkc(ext_f, 1)
                ext_ok = pkc(ext_ok_f, 1)
                ext_map = pkc(ext_map_f, 1)
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

    mask = ((win.take(parity) == color)
            & (win.take(state.weak) != PixelState.WEAK))
    return _commit(state, win, mask, plane_new, cost_new, sel_now,
                   view_weights, use_pk, color)


def _geom_batch(gctx, planes, xs, ys, ref_cam, parity=None, y0=0):
    """Geom cost of K candidate plane fields [K, H', W', 4] -> [K, H', W',
    V] through K3 (dense, or one checkerboard color with ``parity``; the
    H' rows from image row ``y0``)."""
    depths = depth_from_plane(planes, xs, ys, ref_cam)
    return geom_cost(gctx, depths.contiguous(), parity=parity, y0=y0)


_BAND_LANES = 128   # compaction band width (packed columns)


def _weak_budget(SZ: int, frac: float) -> int:
    """Compaction budget K_w: ``frac`` of the evaluation grid, rounded up to
    a multiple of 128, at least 128, at most the grid."""
    K_w = max(-(-int(SZ * frac) // 128) * 128, 128)
    return min(K_w, SZ)


def _window_entries(flat_idx, ok_k, Wc: int, win: RowWindow, SZ: int):
    """The entries of a whole-grid compaction that lie on the window's
    compute rows, in their order, as indices into the compute rows' grid
    (``Wc`` columns, ``SZ`` pixels; SZ for the one empty entry of a window
    that holds none)."""
    lr = torch.remainder(flat_idx // Wc - win.c0, win.H)
    keep = ok_k & (lr < win.hc)
    sel = torch.nonzero(keep)[:, 0]
    local = lr * Wc + flat_idx % Wc
    if sel.numel() == 0:
        return (torch.full((1,), SZ, dtype=flat_idx.dtype,
                           device=flat_idx.device),
                torch.zeros((1,), dtype=torch.bool, device=flat_idx.device))
    return local[sel], keep[sel]


def _band_compact(weak_pk: torch.Tensor, K_w: int):
    """The first K_w weak pixels of the evaluation grid in band-major order
    (bands of 128 columns, rows within a band, columns within a row), as
    JAX's ``jnp.nonzero(size=K_w)`` lists them.

    A cumulative sum ranks the weak pixels on the device, so nothing waits
    for the host.  Past the budget the order decides which weak pixels get
    the anchor term, so it is JAX's.  Returns (flat_idx [K_w] raster indices
    into the grid, SZ for an empty entry; ok_k [K_w] bool)."""
    Hc, Wc = weak_pk.shape
    dev = weak_pk.device
    SZ = Hc * Wc
    band = min(_BAND_LANES, Wc)
    nb = -(-Wc // band)
    Wp = nb * band
    SZp = Hc * Wp
    wpad = torch.zeros((Hc, Wp), dtype=torch.bool, device=dev)
    wpad[:, :Wc] = weak_pk
    mask_bm = wpad.reshape(Hc, nb, band).permute(1, 0, 2).reshape(-1)
    rank = torch.cumsum(mask_bm.to(torch.int32), 0) - 1
    slot = torch.where(mask_bm & (rank < K_w), rank.to(torch.int64),
                       torch.full_like(rank, K_w, dtype=torch.int64))
    p = torch.full((K_w + 1,), SZp, dtype=torch.int64, device=dev)
    p.scatter_(0, slot, torch.arange(SZp, device=dev))   # slot K_w: spill
    p = p[:K_w]
    ok_k = p < SZp
    b, rem = p // (Hc * band), p % (Hc * band)
    r, c = rem // band, rem % band
    flat_idx = torch.where(ok_k, r * Wc + torch.clamp(b * band + c,
                                                      max=Wc - 1),
                           torch.full_like(p, SZ))
    return flat_idx, ok_k


def _propagate_color_weak(state: PMState, anchors: AnchorResult, fit_plane,
                          color: int, it: int, path_it, draws: DrawSource,
                          ctx, ctx_pk, ctx_yzl, ctx_yzl_pk, gctx, ref_img,
                          ref_cam, src_cams, static: PMStatic,
                          dyn: PMDynamic, xs, ys, rx, ry,
                          parity, tap_fields=None, patch_off=None,
                          win: Optional[RowWindow] = None) -> PMState:
    """One weak half-iteration (CheckerboardPropagationWeak,
    APD.cu:2739-3089).

    Costs, geom terms, MHJVS and refinement run on the checkerboard-packed
    half grid (fused backend) or the full grid (exact and warp backends,
    and the exact oracle).  In production mode every slot plane (8
    anchor-plane candidates, current, fit) costs 0.25 x center window +
    0.75 x its own anchor term (K4) at the compacted weak pixels, with each
    anchor's sparse-patch taps where ``tap_fields`` (``pack_tap_fields``) is
    given; the 6 refinement proposals reuse the current plane's anchor term.
    Weak pixels past the budget keep the center-window cost.  Every tile is
    computed: JAX's weak-tile skip changes no result.  With
    ``exact_deformable`` (and ``patch_off``) every slot and every proposal
    takes the reference-exact 9-tap cost (``deformable_cost_exact``) on the
    full grid.  Everything is computed on the window's compute rows; the
    anchors and the fit plane come on them."""
    H, W = ref_img.shape
    V = ctx.num_views
    win = win or RowWindow.whole(H)
    path_c = fold_in(fold_in(path_it, color), 7)
    p_view, p_refine = split(path_c, 2, 0), split(path_c, 2, 1)
    exact = static.exact_deformable and patch_off is not None
    use_pk = ctx_pk is not None and not exact
    pk1, pkc = _packers(win, color, use_pk)
    pk = lambda a: pk1(a, 0)
    rows = None if win.is_whole else win
    par = color if use_pk else None
    ctx_c = ctx_pk if use_pk else ctx
    ctx_yzl_c = ctx_yzl_pk if use_pk else ctx_yzl

    if exact:
        # the reference-exact per-anchor sparse-patch cost (oracle mode)
        def deform(planes):
            return torch.stack([deformable_cost_exact(
                ctx_yzl, p, anchors, patch_off, state.sel_views, ref_img,
                dyn.sigma_color, rows=rows, rays=(rx, ry)) for p in planes])
    else:
        # weak-pixel compaction: the anchor term only matters where a weak
        # pixel can commit, so it runs on a fixed-size list of them
        # (ranked over the whole grid, so the budget and its overflow are
        # the untiled pass's; a row window keeps its own entries)
        weak_all = state.weak == PixelState.WEAK
        weak_pk = pack_parity(weak_all, color) if use_pk else weak_all
        K_w = _weak_budget(weak_pk.numel(), static.weak_budget_frac)
        flat_idx, ok_k = _band_compact(weak_pk, K_w)
        ref_ev = pk(ref_img)
        SZ = ref_ev.numel()
        if rows is not None:
            flat_idx, ok_k = _window_entries(flat_idx, ok_k,
                                             weak_pk.shape[1], win, SZ)
        gidx = torch.clamp(flat_idx, max=SZ - 1)
        af_k = anchor_fields_at(ctx_yzl, anchors, state.sel_views, ref_img,
                                dyn.sigma_color, pkc, gidx, ref_eval=ref_ev)
        tap_w = None
        if tap_fields is not None:
            # one gather at the compacted anchors serves every per-view tap
            ref_c_k = ref_ev.reshape(-1)[gidx]
            tap_w = gather_tap_words(tap_fields, af_k, ref_c_k,
                                     dyn.sigma_color, W,
                                     static.anchor_taps - 1)
        dump = torch.zeros((1, V), device=ref_img.device)

        def scatter_blend(centers, ck):
            """Dense costs [S, H', W', V]: ``ck`` [S, K_w, V] at the
            compacted pixels over ``centers`` elsewhere (empty entries are
            dropped)."""
            S = centers.shape[0]
            out = torch.cat([centers.reshape(S, SZ, V),
                             dump.expand(S, 1, V)], dim=1)
            out[:, flat_idx] = torch.where(ok_k[None, :, None], ck,
                                           torch.zeros_like(ck))
            return out[:, :SZ].reshape(centers.shape)

        def deform_slots(slot_planes):
            """Slot costs with the candidate-dependent anchor term; returns
            the dense blended costs and the compacted anchor term."""
            S = slot_planes.shape[0]
            centers = ncc_cost_batch(ctx_yzl_c, slot_planes, parity=par)
            pl_k = slot_planes.reshape(S, SZ, 4)[:, gidx]
            at_k = anchor_slot_costs_from_ctx(ctx_yzl, pl_k, af_k, ok_k=ok_k,
                                              tap_words=tap_w)
            center_k = centers.reshape(S, SZ, V)[:, gidx]
            ck = torch.where(at_k.has_anchors,
                             0.25 * center_k + 0.75 * at_k.cost, center_k)
            return scatter_blend(centers, ck), at_k

    # candidates: the first 8 anchors' planes (APD.cu:2768-2779)
    a8_x = torch.clamp(anchors.coords[:8, ..., 0], 0, W - 1)
    a8_y = torch.clamp(anchors.coords[:8, ..., 1], 0, H - 1)
    idx8 = pkc(a8_y * W + a8_x, 1).to(torch.int64)         # [8, H', W']
    cand_planes = state.plane.reshape(-1, 4)[idx8]         # [8, H', W', 4]
    flags = pkc(anchors.valid[:8], 1)

    xs_c, ys_c, rx_c, ry_c = pk(xs), pk(ys), pk(rx), pk(ry)
    plane_cur = pk(state.plane)
    sel_cur = pk(state.sel_views)
    fit_c = pkc(fit_plane)

    # one batched deformable evaluation: 8 candidates + current + fit
    slot_planes = torch.cat([cand_planes, plane_cur[None], fit_c[None]])
    if exact:
        slot10 = deform(slot_planes)
    else:
        slot10, at10_k = deform_slots(slot_planes)
    cost_array = slot10[:8]

    # anchor-based view-selection prior (APD.cu:2788-2801)
    sel_a8 = state.sel_views.reshape(-1, V)[idx8]          # [8, H', W', V]
    prior = torch.sum(torch.where(
        flags[..., None],
        torch.where(sel_a8, 0.9, 0.1).to(torch.float32),
        torch.zeros((), device=ref_img.device)), dim=0)

    r = pk1(draws.uniform(p_view, (static.view_samples, H, W, 1)), 1)
    view_weights, temp_sel, weight_norm = mhjvs(r, cost_array, flags, prior,
                                                it)

    if gctx is not None:
        # missing anchors cost geom_factor * 3 (APD.cu:2857-2868)
        g10 = _geom_batch(gctx, slot_planes, xs_c, ys_c, ref_cam,
                          parity=par, y0=win.c0)
        g8 = torch.where(flags[..., None], g10[:8],
                         torch.full_like(g10[:8], 3.0))
        cost_array = cost_array + dyn.geom_factor * g8
    final_costs = weighted_cost(cost_array, view_weights[None],
                                weight_norm[None])
    cur_vec = slot10[8]
    if gctx is not None:
        cur_vec = cur_vec + dyn.geom_factor * g10[8]
    cost0 = weighted_cost(cur_vec, view_weights, weight_norm)

    min_idx = torch.argmin(final_costs, dim=0)
    best_cost = take0(final_costs, min_idx)
    best_plane = take0(cand_planes, min_idx)
    best_flag = take0(flags, min_idx)
    depth_before = depth_from_plane(best_plane, xs_c, ys_c, ref_cam)
    adopt = (best_flag & (depth_before >= dyn.depth_min)
             & (depth_before <= dyn.depth_max) & (best_cost < cost0))
    plane_now = torch.where(adopt[..., None], best_plane, plane_cur)
    cost_now = torch.where(adopt, best_cost, cost0)
    sel_now = torch.where(adopt[..., None], temp_sel, sel_cur)

    # fit-plane test (PlaneHypothesisRefinementWeak, APD.cu:1920-1950)
    has_fit = torch.any(fit_c[..., :3] != 0, dim=-1)
    fit_vec = slot10[9]
    if gctx is not None:
        fit_vec = fit_vec + dyn.geom_factor * g10[9]
    fit_cost = weighted_cost(fit_vec, view_weights, weight_norm)
    fit_depth = depth_from_plane(fit_c, xs_c, ys_c, ref_cam)
    take_fit = (has_fit & (fit_depth >= dyn.depth_min)
                & (fit_depth <= dyn.depth_max) & (fit_cost < cost_now))
    plane_now = torch.where(take_fit[..., None], fit_c, plane_now)
    cost_now = torch.where(take_fit, fit_cost, cost_now)

    # 6-plane random refinement; in production mode the proposals reuse
    # the CURRENT plane's anchor term (slot 8), as JAX does
    cur_depth = depth_from_plane(plane_now, xs_c, ys_c, ref_cam)
    ref_planes = refinement_planes(
        draws, p_refine, plane_now[..., :3], cur_depth, sel_now, rx_c, ry_c,
        xs_c, ys_c, ref_cam, src_cams, dyn.depth_min, dyn.depth_max,
        full_hw=(H, W), pk=pk1)
    if exact:
        ref_vec = deform(ref_planes)
    else:
        ref_centers = ncc_cost_batch(ctx_yzl_c, ref_planes, parity=par)
        center6_k = ref_centers.reshape(6, SZ, V)[:, gidx]
        rk = torch.where(at10_k.has_anchors[8][None],
                         0.25 * center6_k + 0.75 * at10_k.cost[8][None],
                         center6_k)
        ref_vec = scatter_blend(ref_centers, rk)
    if gctx is not None:
        ref_vec = ref_vec + dyn.geom_factor * _geom_batch(
            gctx, ref_planes, xs_c, ys_c, ref_cam, parity=par, y0=win.c0)
    ref_costs = weighted_cost(ref_vec, view_weights[None], weight_norm[None])
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

    if static.state == RunState.REFINE_INIT:
        improved = cost_now < cost0 - 0.1
        plane_new = torch.where(improved[..., None], plane_now, plane_cur)
    else:
        plane_new = plane_now

    # re-cost with the strong full-window NCC for comparability
    # (APD.cu:3072-3088)
    final_vec = ncc_cost(ctx_c, plane_new, parity=par)
    cost_final = weighted_cost(final_vec, view_weights, weight_norm)

    mask = ((win.take(parity) == color)
            & (win.take(state.weak) == PixelState.WEAK))
    return _commit(state, win, mask, plane_new, cost_final, sel_now,
                   view_weights, use_pk, color)


def _weak_overflow(weak, static: PMStatic) -> torch.Tensor:
    """Weak pixels past the compaction budget (the larger of the two colors
    on the packed grid), as an int32 scalar on the device: they fall back
    to the center-window cost.  The weak set only shrinks within a pass, so
    the count at its start bounds every iteration's."""
    wk0 = weak == PixelState.WEAK
    if static.cost_backend == "fused":
        over = None
        for color in (0, 1):
            wpk = pack_parity(wk0, color)
            o = torch.sum(wpk) - _weak_budget(wpk.numel(),
                                              static.weak_budget_frac)
            over = o if over is None else torch.maximum(over, o)
    else:
        over = torch.sum(wk0) - _weak_budget(wk0.numel(),
                                             static.weak_budget_frac)
    return torch.clamp(over, min=0).to(torch.int32)


def _halo(static: PMStatic) -> int:
    """The rows a row window of the pass computes beyond its own on each
    side: none, but on the warp backend, whose taps read the costs of the
    rows within the largest tap shift, the shift times the longest chain of
    cost batches one commit depends on (the strong half: its candidates,
    up to three extension rounds and the refinement; the weak half: its
    slots, the refinement and the final re-cost)."""
    if static.cost_backend != "warp":
        return 0
    shift = int(np.abs(tap_shifts(static.strong_radius)).max())
    return shift * max(2 + min(static.extend_rounds, 3), 3)


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
    label=None,                    # [H, W] int labels
    device=None,
    rows: Optional[Rows] = None,
) -> PassOutput:
    """Run one PatchMatch pass for a reference view on ``device`` (the card
    unless the caller asks for the CPU).  ``draws`` returns its numbers on
    that device.  With ``rows`` this rank computes its rows of a row-tiled
    pass (``dist/tiles.py``) and returns the whole output, as every rank
    of it does."""
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
    win = (RowWindow.whole(H) if rows is None
           else RowWindow(H, rows, _halo(static)))
    rw = None if win.is_whole else win      # a row window, or the image
    take = win.take

    ctx = build_cost_context(
        ref_img, src_imgs, ref_cam, src_cams,
        sigma_spatial=dyn.sigma_spatial, sigma_color=dyn.sigma_color,
        radius_map=radius_map if static.use_radius else None,
        strong_radius=static.strong_radius, backend=static.cost_backend,
        rows=win)
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
    k_init, k_weak, k_loop = (split(root, 3, i) for i in range(3))

    # the edge-adaptive strong branch runs whenever an edge map exists
    edge_dist = None
    if static.use_edge and edge is not None:
        edge = torch.as_tensor(edge, device=dev).to(torch.bool)
        edge_dist = edge_ray_distance(edge)
    if label is not None:
        label = torch.as_tensor(label, device=dev)

    # ---- weak-machinery precomputation ----
    use_apd = static.use_APD
    ctx_yzl = anchors = complexity = label_dist = None
    ctx_yzl_pks = (None, None)
    if use_apd:
        ctx_yzl = build_cost_context(
            ref_img, src_imgs, ref_cam, src_cams,
            sigma_spatial=dyn.sigma_spatial, sigma_color=dyn.sigma_color,
            strong_radius=static.strong_radius, backend=static.cost_backend,
            color_only_weights=True, rows=win)
        if static.cost_backend == "fused":
            ctx_yzl_pks = (pack_ctx(ctx_yzl, 0), pack_ctx(ctx_yzl, 1))
        if static.use_edge and edge is not None:
            complexity = edge_complexity(edge, static.strong_radius)
        if static.use_label and label is not None:
            label_dist = label_boundary_distance(label)
        if static.state == RunState.REFINE_INIT and static.use_detail:
            weak = demote_detail(
                weak, edge if static.use_edge and edge is not None else None,
                label if static.use_label and label is not None else None)

    # ---- initialization (RandomInitialization, APD.cu:1273-1309) ----
    # (on the compute rows, then exchanged: a row window's exchange makes
    # the state whole on every rank)
    if static.state == RunState.FIRST_INIT:
        rand_d = take(random_depth(draws, split(k_init, 2, 0), (H, W),
                                   dyn.depth_min, dyn.depth_max))
        rand_n = visibility_prior_normal(draws, split(k_init, 2, 1), rand_d,
                                         take(sel_views), take(rx), take(ry),
                                         ref_cam, src_cams, full_hw=(H, W),
                                         pk=take)
        plane = plane_from_normal_depth(rand_n, rand_d, take(xs), take(ys),
                                        ref_cam)
        if init_plane_world is not None:
            init_plane_world = take(f32(init_plane_world))
            prior_d = init_plane_world[..., 3]
            ok = (prior_d >= dyn.depth_min) & (prior_d <= dyn.depth_max)
            prior_plane = plane_from_world(init_plane_world, take(xs),
                                           take(ys), ref_cam)
            plane = torch.where(ok[..., None], prior_plane, plane)
        cost, sel_views = _initial_cost_first(ctx, plane, static.top_k)
        plane = win.commit(plane)
    else:
        if init_plane_world is None or init_sel_views is None:
            raise ValueError("REFINE passes need init_plane_world and "
                             "init_sel_views")
        plane = plane_from_world(f32(init_plane_world), xs, ys, ref_cam)
        cost, sel_views = _initial_cost_refine(ctx, take(plane),
                                               take(sel_views))
    cost, sel_views = win.commit(cost), win.commit(sel_views)

    # anchor generation (GenNeighbours + NeigbourUpdate)
    weak_overflow = tap_fields = patch_off = None
    if use_apd:
        if static.exact_deformable:
            patch_off = patch_candidates(ref_img, sel_views, dyn.sigma_color,
                                         weak_radius=static.weak_radius)
        elif static.anchor_taps > 1:
            # the sparse-patch taps: per-view visibility-aware candidates
            # (APD.cu:3744-3794), packed into per-anchor-position words
            # once a pass
            patch_off = patch_candidates(ref_img, sel_views, dyn.sigma_color,
                                         weak_radius=static.weak_radius)
            tap_fields = pack_tap_fields(ref_img, patch_off,
                                         static.anchor_taps - 1)
        depth_range = float(np.float32(dyn.depth_max)
                            - np.float32(dyn.depth_min))
        anchors = find_anchors(
            weak, plane, ref_cam, draws, k_weak,
            rotate_time=static.rotate_time,
            edge=edge if static.use_edge else None, complexity=complexity,
            ransac_threshold=dyn.ransac_threshold, depth_range=depth_range,
            use_limit=static.use_limit,
            label=label if static.use_label else None,
            label_dist=label_dist, rows=rw)
        weak_c = take(weak)
        weak = win.commit(torch.where(
            (weak_c == PixelState.WEAK) & ~anchors.reliable,
            torch.full_like(weak_c, int(PixelState.UNKNOWN)), weak_c))
        if not static.exact_deformable:
            weak_overflow = _weak_overflow(weak, static)

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
                edge=edge, edge_dist=edge_dist, win=win)
        if use_apd:
            fit_plane, new_radius = ransac_fit_plane(
                anchors, state.plane, state.weak, ref_cam, draws,
                fold_in(path_it, 3), use_radius=static.use_radius,
                strong_radius=static.strong_radius, edge_dist=edge_dist,
                label_dist=label_dist, rows=rw)
            if static.use_radius and new_radius is not None:
                state = state.replace(radius=win.commit(torch.where(
                    take(state.weak) == PixelState.WEAK, new_radius,
                    take(state.radius))))
            for color in (0, 1):
                state = _propagate_color_weak(
                    state, anchors, fit_plane, color, it, path_it, draws,
                    ctx, ctx_pks[color], ctx_yzl, ctx_yzl_pks[color], gctx,
                    ref_img, ref_cam, src_cams, static, dyn, xs, ys, rx, ry,
                    parity, tap_fields=tap_fields, patch_off=patch_off,
                    win=win)

    # ---- post: depth/normal extraction + filters ----
    depth = depth_from_plane(state.plane, xs, ys, ref_cam)
    normal_ref = state.plane[..., :3]
    depth = median_filter_depth(depth, state.weak, state.cost, rows=rw)
    weak_new = depth_to_weak(
        ctx, gctx, dyn.geom_factor, normal_ref, depth, state.sel_views,
        state.view_weights, xs, ys, ref_cam, src_cams,
        dyn.depth_min, dyn.depth_max, dyn.weak_peak_radius,
        return_curve=static.debug_dumps, rows=rw)
    cost_line = None
    if static.debug_dumps:
        weak_new, cost_line = weak_new
        cost_line = win.commit(cost_line, 1)
    weak_new = win.commit(weak_new)
    depth = win.commit(local_refine(
        ctx, gctx, dyn.geom_factor, normal_ref, depth, state.sel_views,
        state.view_weights, xs, ys, ref_cam, src_cams,
        dyn.depth_min, dyn.depth_max, rows=rw))

    # host-extraction semantics (main.cpp:300-308): out-of-range -> 0/UNKNOWN
    in_range = (depth >= dyn.depth_min) & (depth <= dyn.depth_max)
    depth = torch.where(in_range, depth, torch.zeros_like(depth))
    weak_new = torch.where(in_range, weak_new,
                           torch.full_like(weak_new, int(PixelState.UNKNOWN)))

    normal_world = fmath.rmatvec(ref_cam.R, normal_ref)
    radius_out = torch.where(state.radius == 0,
                             torch.full_like(state.radius,
                                             float(static.strong_radius)),
                             state.radius)
    dbg = {}
    if static.debug_dumps:
        dbg["cost_line"] = cost_line
        if use_apd:
            dbg["anchors_xy"] = win.commit(anchors.coords, 1)
            dbg["anchors_valid"] = win.commit(anchors.valid, 1)
    return PassOutput(depth=depth, normal_world=normal_world,
                      cost=state.cost, weak=weak_new,
                      sel_views=state.sel_views,
                      view_weights=state.view_weights, radius=radius_out,
                      weak_overflow=weak_overflow, **dbg)
