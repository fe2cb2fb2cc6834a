#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvpmvs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile | --dist-only]

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels (csrc/*.cu, one nvcc per source, in
   parallel) into build/dvpmvs_torch/ and prints each kernel's registers,
   shared memory and spills (-Xptxas -v);
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it (608x800, V=10; K4 at the
   compacted weak pixels of one color of a 30 % weak mask, K_w = 121,600,
   in its single-tap mode and in its tap mode with two sparse-patch taps;
   K5 on the ground-truth plane field; the seven K6 gather kernels at their
   own shapes, each beside its floor of the work as written and an empty
   launch), and times both with CUDA events; K5's row also times
   torch.nn.functional.grid_sample on the same coordinates, which computes
   its bilinear sample (the port never calls it); after the path phases,
   K4 again at the bench scene's own compaction (the round-0 weak map of
   view 0 that the APD passes start from: ~5,900 weak pixels in 121,600
   compacted entries), both modes; the warp backend's NCC kernel
   (launch_warp_ncc of csrc/warp.cu: K5's warp of each tile and its halo
   into shared memory and the 36 tap moments there) on one ground-truth
   plane and on 17 perturbed planes with the radius map's tap weights,
   against its plain version (K5's plain field and 36 rolled moment sums
   per plane);
4. path phase, round 0: runs the main path of pyramid round 0 through the
   port's entry point run_pass with the "fused" backend: FIRST_INIT on
   views 0-4 of a synthetic 608x800 scene (10 replicated source views,
   Canny edges, 3 iterations), then REFINE_ITER on view 0 with the radius
   map of its FIRST_INIT output (as the scene runner passes it) and without
   (as the JAX bench does); checks depth accuracy against the ground truth
   and that each of K1, K2 and K3 (fold, per view) was launched;
5. path phase, the weak-pixel (APD) passes of rounds >= 1: REFINE_INIT of
   round 1 on view 0 from its FIRST_INIT output, then REFINE_ITER in the
   JAX bench's configuration (use_APD, geometric consistency against the
   other views' FIRST_INIT depths, 3 iterations); checks acc2, that the
   pass had weak pixels, and that K4 and K3's parity mode were launched;
   then the same chain on a scene with a textureless band, whose weak
   region's acc2 it prints before and after;
6. path phase, the "warp" cost backend: FIRST_INIT of view 0 from random
   planes (acc2 printed, no floor: warp mode converges slowly from random
   planes), then REFINE_ITER from the "fused" FIRST_INIT outputs in round
   0's configuration (radius map, geometric consistency); checks acc2 of
   REFINE_ITER, that the warp NCC kernel ran once for every batch the
   backend evaluated in both passes and costed every plane it evaluated
   (K5 alone never runs there), and that K3's per-view mode ran in the
   sweeps; prints the fused REFINE_ITER's wall and acc2 of step 4 beside
   the warp REFINE_ITER's;
7. path phase, the sparse-patch taps: the APD REFINE_ITER of step 5 with
   anchor_taps=3 on the bench scene (acc2 floor) and on the band scene (its
   region's acc2 beside step 5's); checks that K4's tap mode was launched;
8. scene phase: the port's CLI ``scene`` command on an 11-view 608x800
   synthetic scene folder (10 sources per view, the defaults: round 0's
   four passes over every view, then ETH3D fusion to APD.ply, with a
   checkpoint); prints each pass's wall, the fusion wall, the scene's
   wall, the point count, each view's acc2, the share of points near a
   ground-truth plane and the host time of the Canny prior; checks that
   K1, K2 and K3 (per view: the runner passes radius maps, so no sweep
   takes the fold) were launched in the run and that a resumed run runs
   no pass and writes the same PLY;
9. rounds phase: the rounds >= 1 of a scene with both priors, on an
   11-view 608x800 folder with sfm/ points: the CLI's ``prior`` command
   (Depth-Anything-V2 ViT-S, random weights from a seed) timed per view,
   the label maps' host time, then ``scene --mono-prior --max-base-size
   400 --full-res-round``: round 0 at 304x400 from the mono planes, round
   1 at 608x800 (REFINE_INIT and 3 APD REFINE_ITER with computed label
   maps), ETH3D fusion; prints each pass's wall against the time inside
   run_pass, the label maps' time, each view's acc2 and the fused cloud;
   checks that K1, K2, K3 (per view, parity) and K4 were launched in the
   run;
10. exact phase: the APD REFINE_ITER of step 5's band scene, view 0, with
   the reference-exact deformable oracle (``exact_deformable``) from the
   same band FIRST_INIT; prints its wall, device events and busy time (one
   more run under torch.profiler), acc2 and the textureless region's acc2
   beside the production passes of steps 5 and 7 on the band scene (also
   profiled once); checks that K1 and K3 (per view: the exact weak
   half-iterations run on the full grid) ran and K4 did not;
11. debug phase: ``debug_dumps`` through SceneRunner on the bench scene
   (FIRST_INIT of its 5 views, then view 0's APD REFINE_ITER): the three
   dump files' headers and sizes, and each cost curve's minimum within 2
   steps of the solved depth at >= 90 % of the textured pixels; then
   ``show_medium_result`` over round 0 of a two-view folder where PIL
   imports (it prints whether it ran);
12. dist phase: the scene phase's 11-view 608x800 folder, round 0 through
   the batched schedule (mesh_views=2) in this process, over two ranks
   (spawned processes: gloo on the one card, NCCL on two cards) and over
   a one-rank NCCL group: every depth map bit for bit equal to the
   one-process run, K1, K2 and K3 (per view) launched in every rank;
   run_fusion_sharded against run_fusion and its pair fields on the card
   against the CPU's; a two-host MultiHostRunner round 0 with the file
   sync and with the collective exchange, the same depths (the phase's
   docstring has the checks; ``--dist-only`` runs this phase alone and
   prints no result line);
13. with ``--profile`` only: runs each pass once more under torch.profiler
   and prints the device's busy time and the device time by kernel, and
   the same for the anchor search and one RANSAC fit on their own;
14. prints one JSON line with the kernels' numbers, the card line, and as
   the last line {"ok": true, "device": {...}}.

Every path step resets the launch counts just before it and reads them just
after.  Any failure raises, so the script exits non-zero before the last
line.  It needs a CUDA device and the repository's dvpmvs_torch package
beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

H, W, V = 608, 800, 10
ITERS = 3
MARGIN = 8
ACC2_FLOOR = 0.90
# H100 SXM published peaks (fp32 outside the tensor cores; HBM3)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Operation counts per unit of work, counted from each kernel's arithmetic
# (an FMA counts 2, a divide, clamp or floor 1), for the roofline bound.
K1_OPS_PER_TAP = 30          # warp (3 affine), divide, clamps, bilinear, moments
K1_OPS_PER_VIEW = 60         # homography terms, in-view test, NCC tail
K2_OPS_PER_FIELD = 35        # one warped-field bilinear sample
K2_OPS_PER_TAP = 7           # three moment updates from the field
K2_OPS_PER_VIEW = 30         # in-view test, NCC tail, weighted fold
# K3 per (candidate, pixel, view), the least arithmetic of the function: the
# composed form of geom_pallas.py:78-113 (M r hoisted per pixel and view,
# 1 / d per candidate): h = M r + b / d 6, guard 2, quotients 2, nearest
# pixel (add, convert, clamp) 6, back-projection 6, h2 = N X + g 18, guard 2,
# quotients 2, differences 2, distance 4, min 1, invalid test 3; the fold
# adds its weighted sum (2).  The kernel keeps the plain version's steps:
# ~150 instructions.
K3_OPS_PER_VIEW = 54
K3_OPS_FOLD = 2
# K4 per (slot, pixel, view, anchor): ray . q 4, homography rows 18, front
# and guard 3, divides 2, in-view 4, clamps 4, floors 2, fractions 2,
# bilinear blend 11, shifts by c0 2, weight select 1, moments 15, counts 2
K4_OPS_PER_ANCHOR = 70
K4_OPS_PER_GROUP = 25        # the group's NCC from its moments
K4_OPS_PER_VIEW = 10         # the groups' mean and the out-of-view blend
# K4's tap mode, per tap of an anchor: unpack 10, ray offset 4, then the
# center's warp, sample and moments without the counts (~66)
K4_OPS_PER_TAP = 80
N_TAPS = 2                   # anchor_taps=3: two taps per anchor
WEAK_FRAC = 0.3              # the random weak share of the K4 inputs
S_SLOTS, N_ANCHORS = 10, 11
# K5 per (view, pixel): base rows 18, guard 2, divides 2, in-view 5, clamps
# 4, floors 2, fractions 2, bilinear blend 11; per pixel: ray 4, s 5
K5_OPS_PER_VIEW = 46
K5_OPS_PER_PIXEL = 9
# the warp backend's NCC per (plane, pixel, view): K5's warp once (its halo
# recomputation is not counted), 36 taps of 3 moment updates (216), the
# tail (moments 3, variance and covariance 4, product, clamp, sqrt, clamp,
# divide, 1 - ncc, clamp 2, tests and select 3: 18); per (plane, pixel):
# K5's ray and s, and the reference side (1 / sum_w, m_ref, var_ref: 5)
WARP_NCC_OPS_PER_VIEW = K5_OPS_PER_VIEW + 36 * 6 + 18
WARP_NCC_OPS_PER_PIXEL = K5_OPS_PER_PIXEL + 5
# K6 per step (one tap, with its 8 inner steps for the prims) and pixel,
# counted from each kernel: index arithmetic, clamps, byte unpacking, and for
# quad8 / p2x5 the f32 blend (integer operations counted at the fp32 rate:
# an optimistic bound).  prim_repeat's 8 inner adds of one word fold into a
# shift and an add.
K6_OPS_PER_STEP = {"quad8": 41, "p2x5": 47, "prim_roll": 51,
                   "prim_gather": 51, "prim_select": 29, "prim_repeat": 6,
                   "prim_vshift": 43}

REPLACES = {
    "ncc_fused": "dvpmvs/kernels/ncc_fused.py:864",
    "sweep": "dvpmvs/kernels/sweep_pallas.py:286",
    "geom": "dvpmvs/kernels/geom_pallas.py:208",
    "anchor": "dvpmvs/kernels/anchor_pallas.py:394",
    "warp": "dvpmvs/kernels/sweep_pallas.py:408",
    "warp_ncc": "dvpmvs/kernels/sweep_pallas.py:408",
    "gather_bench": "scripts/bench_gather_variants.py:204",
}
SOURCES = {
    "ncc_fused": "dvpmvs_torch/csrc/ncc_fused.cu",
    "sweep": "dvpmvs_torch/csrc/sweep.cu",
    "geom": "dvpmvs_torch/csrc/geom.cu",
    "anchor": "dvpmvs_torch/csrc/anchor.cu",
    "warp": "dvpmvs_torch/csrc/warp.cu",
    "warp_ncc": "dvpmvs_torch/csrc/warp.cu",
    "gather_bench": "dvpmvs_torch/csrc/gather_bench.cu",
}
# which run's launch counts each counter is read from: the round-0 path
# unless listed (K6 lies on no path: its own timing run; K5 alone is read
# from the warp path, which launches it no time)
COUNTER_RUN = {"anchor/single tap": "apd", "geom/parity": "apd",
               "warp/ncc": "warp", "warp/field": "warp",
               "anchor/taps": "taps"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over reps launches (after one warm-up),
    with the launches queued behind a spin of the card
    (``gather_variants.cuda_ms``): device time, not the host's launch rate."""
    from dvpmvs_torch.bench.gather_variants import cuda_ms as timed_ms
    return timed_ms(fn, reps)


def compare(torch, got, want, bound: float, share_max: float, what: str):
    """max / median |got - want| and the share above ``bound``; NaN in both
    counts as agreement, NaN in one as a disagreement."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    d = torch.abs(got - want)
    d = torch.where(both_nan, torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    d = d.flatten().double()
    mx = float(d.max())
    med = float(d.median())
    share = float((d > bound).double().mean())
    print(f"  {what}: max|d|={mx:.3e} median|d|={med:.3e} "
          f"share(|d|>{bound:g})={share:.3e} (allowed {share_max:g})",
          flush=True)
    if not (share <= share_max and med <= bound):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (share {share:.3e}, median {med:.3e})")
    return mx


def bound_ms(ops: float, nbytes: float):
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phase(torch, dev, scene, reps):
    """Each kernel vs its plain version at main-path shapes."""
    from dvpmvs_torch.engine.packing import pack_ctx, pack_parity
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.kernels import geom_fused, ncc_fused, sweep_fused
    from dvpmvs_torch.kernels.geom import build_geom_context
    from dvpmvs_torch.kernels.ncc import _grid, build_cost_context
    from dvpmvs_torch.kernels.sampling import plane_from_normal_depth
    from dvpmvs_torch.kernels.sweep import _mean_selected_baseline

    ref_cam = scene.cameras[0].to(dev)
    src_cams = stack_cameras([scene.cameras[i] for i in reps]).to(dev)
    ref_img = torch.as_tensor(scene.images[0], device=dev)
    src_imgs = torch.as_tensor(scene.images[reps], device=dev).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)

    ctx = build_cost_context(ref_img, src_imgs, ref_cam, src_cams, 5.0, 3.0,
                             backend="fused")
    rmap = 3.0 + 4.0 * rand(H, W)
    ctx_r = build_cost_context(ref_img, src_imgs, ref_cam, src_cams, 5.0,
                               3.0, radius_map=rmap, backend="fused")
    ctx_pk = pack_ctx(ctx, 0)
    xs, ys = _grid(H, W, dev)
    gt_depth = torch.as_tensor(scene.gt_depth[0], device=dev)
    gt_plane = plane_from_normal_depth(
        torch.as_tensor(scene.gt_normal[0], device=dev), gt_depth, xs, ys,
        ref_cam)

    def planes(B):
        p = gt_plane[None].repeat(B, 1, 1, 1)
        p[..., 3] *= 1.0 + 0.1 * (rand(B, H, W) - 0.5)
        return p

    rows = []
    P_full, P_pk = H * W, H * ((W + 1) // 2)
    k1_cases = [("B=17, packed, r=5", 17, ctx_pk, 0),
                ("B=6, packed, r=5", 6, ctx_pk, 0),
                ("B=8, dense, per-pixel r", 8, ctx_r, None)]
    for label, B, c, par in k1_cases:
        pl = planes(B)
        if par is not None:
            pl = pack_parity(pl, par, axis=1).contiguous()
        wsums = torch.stack([c.sum_w, c.sum_wref, c.sum_wref2])
        args = (pl.contiguous(), c.w_taps.contiguous(),
                c.wref_taps.contiguous(), wsums, c.src_imgs, c.M, c.b, c.cam,
                c.src_wh)
        kw = dict(radius=5.0, radius_map=c.radius.contiguous()
                  if c.has_radius_map else None, parity=par)
        got = ncc_fused.fused_ncc_costs(*args, **kw)
        want = ncc_fused.fused_ncc_costs_plain(*args, **kw)
        torch.cuda.synchronize()
        err = compare(torch, got, want, 1e-3, 1e-3, f"ncc_fused {label}")
        ms = cuda_ms(torch, lambda: ncc_fused.fused_ncc_costs(*args, **kw), 5)
        plain = cuda_ms(torch, lambda: ncc_fused.fused_ncc_costs_plain(
            *args, **kw), 1)
        P = P_pk if par is not None else P_full
        ops = P * B * V * (36 * K1_OPS_PER_TAP + K1_OPS_PER_VIEW)
        nbytes = 4 * (B * P * 4 + 2 * 36 * P + 3 * P + V * H * W
                      + (P if c.has_radius_map else 0) + B * P * V)
        rows.append(("ncc_fused", "ncc_fused", label, err, ms, plain,
                     *bound_ms(ops, nbytes), None))

    sel = torch.ones((H, W, V), dtype=torch.bool, device=dev)
    baseline, _ = _mean_selected_baseline(sel, ref_cam, src_cams)
    vw = rand(H, W, V)
    for K, k0 in ((61, 30), (11, 5)):
        label = f"K={K}"
        invd0 = (1.0 / torch.clamp(gt_depth, min=1e-12)).contiguous()
        fxbl = ref_cam.fx * baseline
        invbl = torch.where(fxbl > 0, 1.0 / torch.clamp(fxbl, min=1e-12),
                            torch.zeros_like(fxbl)).contiguous()
        wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
        args = (invd0, invbl, torch.movedim(vw, -1, 0).contiguous(),
                ctx.w_taps, ctx.wref_taps, wsums, ctx.src_imgs, ctx.M,
                ctx.b, ctx.cam, ctx.src_wh)
        got = sweep_fused.sweep_weighted_ncc(*args, K=K, k0=k0)
        want = sweep_fused.sweep_weighted_ncc_plain(*args, K=K, k0=k0)
        torch.cuda.synchronize()
        err = compare(torch, got, want, 5e-3, 1e-3, f"sweep {label}")
        ms = cuda_ms(torch, lambda: sweep_fused.sweep_weighted_ncc(
            *args, K=K, k0=k0), 5)
        plain = cuda_ms(torch, lambda: sweep_fused.sweep_weighted_ncc_plain(
            *args, K=K, k0=k0), 1)
        ops = H * W * V * K * (K2_OPS_PER_FIELD + 36 * K2_OPS_PER_TAP
                               + K2_OPS_PER_VIEW)
        nbytes = 4 * (2 * H * W + V * H * W + 72 * H * W + 3 * H * W
                      + V * H * W + K * H * W)
        rows.append(("sweep", "sweep", label, err, ms, plain,
                     *bound_ms(ops, nbytes), None))

    src_depths = torch.as_tensor(scene.gt_depth[reps], device=dev)
    gctx = build_geom_context(src_depths, ref_cam, src_cams)
    disp = ref_cam.fx * baseline / gt_depth
    for label, K, fold in (("fold, K=61", 61, True),
                           ("per view, K=8", 8, False)):
        k0 = K // 2
        ks = torch.arange(K, dtype=torch.float32, device=dev) - k0
        dstack = (ref_cam.fx * baseline / (disp[None] + ks[:, None, None])
                  ).contiguous()
        kw = dict(vweights=vw if fold else None, fold=fold)
        got = geom_fused.geom_cost(gctx, dstack, **kw)
        want = geom_fused.geom_cost_plain(gctx, dstack, **kw)
        torch.cuda.synchronize()
        err = compare(torch, got, want, 1e-3, 1e-3, f"geom {label}")
        ms = cuda_ms(torch, lambda: geom_fused.geom_cost(gctx, dstack, **kw),
                     5)
        plain = cuda_ms(torch, lambda: geom_fused.geom_cost_plain(
            gctx, dstack, **kw), 1)
        ops = K * H * W * V * (K3_OPS_PER_VIEW + (K3_OPS_FOLD if fold else 0))
        nbytes = 4 * (K * H * W + V * H * W
                      + (V * H * W + K * H * W if fold else K * H * W * V))
        rows.append(("geom", "geom/fold" if fold else "geom/per view",
                     label, err, ms, plain, *bound_ms(ops, nbytes), None))

    # K3's parity mode: the geom term of the weak half-iterations (10 slot
    # planes, 6 refinement proposals) on one checkerboard color
    Wp = (W + 1) // 2
    for K in (10, 6):
        for color in (0, 1):
            label = f"parity {color}, K={K}"
            ks = 1.0 + 0.02 * (torch.arange(K, dtype=torch.float32,
                                            device=dev) - K // 2)
            dstack = (pack_parity(gt_depth, color)[None]
                      * ks[:, None, None]).contiguous()
            got = geom_fused.geom_cost(gctx, dstack, parity=color)
            want = geom_fused.geom_cost_plain(gctx, dstack, parity=color)
            torch.cuda.synchronize()
            err = compare(torch, got, want, 1e-3, 1e-3, f"geom {label}")
            ms = cuda_ms(torch, lambda: geom_fused.geom_cost(
                gctx, dstack, parity=color), 5)
            plain = cuda_ms(torch, lambda: geom_fused.geom_cost_plain(
                gctx, dstack, parity=color), 1)
            ops = K * H * Wp * V * K3_OPS_PER_VIEW
            nbytes = 4 * (K * H * Wp + V * H * W + K * H * Wp * V)
            rows.append(("geom", "geom/parity", label, err, ms, plain,
                         *bound_ms(ops, nbytes), None))

    rows += k4_rows(torch, dev, ref_img, src_imgs, ref_cam, src_cams,
                    gt_plane, rand)
    rows += k5_rows(torch, dev, ctx, gt_plane)
    rows += warp_ncc_rows(torch, ctx, ctx_r, planes, gt_plane)
    rows += k6_rows(torch, dev)
    return rows


def k4_rows(torch, dev, ref_img, src_imgs, ref_cam, src_cams, gt_plane,
            rand):
    """K4 at the main path's shapes: the anchors that find_anchors gives a
    30 % random weak mask on the ground-truth planes, compacted on one
    checkerboard color (K_w = 121,600 at 608x800), 10 slot planes; in the
    single-tap mode and with two sparse-patch taps per anchor."""
    import numpy as np
    from dvpmvs_torch.config import PixelState
    from dvpmvs_torch.kernels.weak import find_anchors
    from dvpmvs_torch.rng import TorchDraws

    rng = np.random.default_rng(0)
    weak = torch.as_tensor(np.where(rng.uniform(size=(H, W)) < WEAK_FRAC,
                                    PixelState.WEAK, PixelState.STRONG)
                           .astype(np.int8), device=dev)
    anchors = find_anchors(weak, gt_plane, ref_cam, TorchDraws(0, dev), (),
                           rotate_time=4, depth_range=float(
                               ref_cam.depth_max - ref_cam.depth_min))
    sel = torch.ones((H, W, V), dtype=torch.bool, device=dev)
    return k4_cell_rows(torch, dev, "", weak, anchors, gt_plane, sel,
                        ref_img, src_imgs, ref_cam, src_cams, rand)


def k4_path_rows(torch, dev, scene, first):
    """K4 at the bench scene's own compaction in the APD REFINE_ITER: the
    round-0 weak map of view 0 (FIRST_INIT's output, the pass's input),
    its anchors as the pass searches them (edges, edge complexity), its
    selected views, slot planes around its FIRST_INIT planes, compacted on
    one color at the pass's budget (half the packed grid, mostly fill)."""
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.geometry.transforms import plane_from_world
    from dvpmvs_torch.kernels.ncc import _grid
    from dvpmvs_torch.kernels.weak import edge_complexity, find_anchors
    from dvpmvs_torch.rng import TorchDraws

    reps, cam, edge = problem(torch, scene, 0)
    cam, edge = cam.to(dev), edge.to(dev)
    out0 = first[0][0]
    xs, ys = _grid(H, W, dev)
    plane = plane_from_world(torch.cat(
        [out0.normal_world, out0.depth[..., None]], -1), xs, ys, cam)
    anchors = find_anchors(out0.weak, plane, cam, TorchDraws(0, dev), (),
                           rotate_time=4, edge=edge,
                           complexity=edge_complexity(edge, 5),
                           depth_range=float(cam.depth_max - cam.depth_min))
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    src_cams = stack_cameras([scene.cameras[i] for i in reps]).to(dev)
    src_imgs = torch.as_tensor(scene.images[reps], device=dev).contiguous()
    ref_img = torch.as_tensor(scene.images[0], device=dev)
    return k4_cell_rows(torch, dev, "path compaction, ", out0.weak, anchors,
                        plane, out0.sel_views, ref_img, src_imgs, cam,
                        src_cams, rand)


def k4_cell_rows(torch, dev, tag, weak, anchors, plane, sel, ref_img,
                 src_imgs, ref_cam, src_cams, rand):
    """K4 against its plain version on the weak pixels of ``weak`` with
    ``anchors``, compacted on color 0 at the weak half-iterations' budget,
    10 slot planes around ``plane``: single tap and two taps.  The bound
    counts the operations of the (k, v) with a usable anchor, and the bytes
    that the function needs: the others' fixed result is written without
    warping and without reading their planes, fields or tap words."""
    from dvpmvs_torch.config import PixelState
    from dvpmvs_torch.engine.packing import pack_parity
    from dvpmvs_torch.engine.patchmatch import _band_compact, _weak_budget
    from dvpmvs_torch.kernels import anchor_fused
    from dvpmvs_torch.kernels.deformable import (anchor_fields_at,
                                                 gather_tap_words,
                                                 pack_tap_fields)
    from dvpmvs_torch.kernels.ncc import build_cost_context
    from dvpmvs_torch.kernels.weak import patch_candidates

    ctx_yzl = build_cost_context(ref_img, src_imgs, ref_cam, src_cams, 5.0,
                                 3.0, backend="fused",
                                 color_only_weights=True)
    color = 0
    pk1 = lambda a, axis=0: pack_parity(a, color, axis)
    weak_pk = pk1(weak == PixelState.WEAK)
    SZ = weak_pk.numel()
    K_w = _weak_budget(SZ, 0.5)
    flat_idx, ok_k = _band_compact(weak_pk, K_w)
    gidx = torch.clamp(flat_idx, max=SZ - 1)
    af = anchor_fields_at(ctx_yzl, anchors, sel, ref_img, 3.0, pk1, gidx)
    plane_k = pk1(plane).reshape(SZ, 4)[gidx]
    planes = plane_k[None].repeat(S_SLOTS, 1, 1)
    planes[..., 3] *= 1.0 + 0.1 * (rand(S_SLOTS, K_w) - 0.5)
    n_weak = int(ok_k.sum())
    n_valid = int(af.valid[:, ok_k].sum())
    # the tap mode's words: the scene's patch candidates, packed once,
    # gathered at the compacted anchors
    patch_off = patch_candidates(ref_img, sel, 3.0, weak_radius=5)
    tap_fields = pack_tap_fields(ref_img, patch_off, N_TAPS)
    tap_w = gather_tap_words(tap_fields, af, pk1(ref_img).reshape(-1)[gidx],
                             3.0, W, N_TAPS)

    vbits = anchor_fused.kernel_args(ctx_yzl, planes, af, ok_k)[9]
    n_kv = sum(int(((vbits >> v) & 1).any(0).sum()) for v in range(V))
    print(f"  K4 inputs ({tag or 'kernel cell, '}K_w {K_w}): weak pixels "
          f"{n_weak}, valid anchors {n_valid} of {N_ANCHORS * n_weak}, "
          f"(pixel, view) with a usable anchor {n_kv} of {K_w * V}",
          flush=True)

    rows = []
    for n_taps, words in ((0, None), (N_TAPS, tap_w)):
        args = anchor_fused.kernel_args(ctx_yzl, planes, af, ok_k, words)
        run = lambda: anchor_fused.anchor_slot_costs(*args)
        got = run()
        want = anchor_fused.anchor_slot_costs_plain(*args)
        torch.cuda.synchronize()
        label = f"{tag}S={S_SLOTS}, K={K_w}, A={N_ANCHORS}" + (
            f", {n_taps} taps" if n_taps else "")
        if not torch.equal(got.has_anchors, want.has_anchors):
            raise AssertionError(f"anchor ({label}): has_anchors differs "
                                 "from the plain version")
        err = compare(torch, got.cost, want.cost, 1e-3, 1e-3,
                      f"anchor {label}")
        ms = cuda_ms(torch, run, 5)
        plain = cuda_ms(torch, lambda: anchor_fused.anchor_slot_costs_plain(
            *args), 1)
        ops = S_SLOTS * n_kv * (
            N_ANCHORS * (K4_OPS_PER_ANCHOR + n_taps * K4_OPS_PER_TAP)
            + 2 * K4_OPS_PER_GROUP + K4_OPS_PER_VIEW)
        # bytes as the operations: every output and every entry's view
        # bits; the slot planes and the other anchor fields of the weak
        # pixels only; the tap words of the usable (k, v) only; the sources
        nbytes = (5 * S_SLOTS * K_w * V + 4 * N_ANCHORS * K_w
                  + 4 * n_weak * (3 * S_SLOTS + 4 * N_ANCHORS)
                  + 4 * n_taps * N_ANCHORS * n_kv + 4 * V * H * W)
        rows.append(("anchor", "anchor/taps" if n_taps else
                     "anchor/single tap", label, err, ms, plain,
                     *bound_ms(ops, nbytes), None))
    return rows


def k5_rows(torch, dev, ctx, gt_plane):
    """K5 on the ground-truth plane field at 608x800, V=10, against its
    plain version, and grid_sample (border, align_corners) on the same
    coordinates: the bilinear sample that is the bulk of K5's work.  K5
    alone lies on no path since the warp backend's NCC kernel took its
    place there: its launches are the warp path's, 0."""
    import torch.nn.functional as F
    from dvpmvs_torch.kernels import warp_fused

    args = (gt_plane.contiguous(), ctx.src_imgs, ctx.M, ctx.b, ctx.cam,
            ctx.src_wh)
    run = lambda: warp_fused.warp_field(*args)
    got_w, got_iv = run()
    want_w, want_iv = warp_fused.warp_field_plain(*args)
    torch.cuda.synchronize()
    label = f"V={V}, {H}x{W}"
    if not torch.equal(got_iv, want_iv):
        raise AssertionError("warp: in_view differs from the plain version")
    err = compare(torch, got_w, want_w, 1e-3, 1e-3, f"warp {label}")
    print(f"  warp: in view at {float(got_iv.float().mean()):.4f} of the "
          "entries", flush=True)
    ms = cuda_ms(torch, run, 20)
    plain = cuda_ms(torch, lambda: warp_fused.warp_field_plain(*args), 3)
    px, py, _ = warp_fused.warp_coords(gt_plane, ctx.M, ctx.b, ctx.cam,
                                       ctx.src_wh)
    grid = torch.stack([2.0 * px / (W - 1) - 1.0, 2.0 * py / (H - 1) - 1.0],
                       dim=-1).contiguous()
    src = ctx.src_imgs[:, None]
    lib_run = lambda: F.grid_sample(src, grid, mode="bilinear",
                                    padding_mode="border",
                                    align_corners=True)
    d = torch.abs(lib_run()[:, 0] - want_w).flatten().double()
    print(f"  grid_sample on K5's coordinates vs K5's plain version: "
          f"max|d|={float(d.max()):.3e} median|d|={float(d.median()):.3e}",
          flush=True)
    lib_ms = cuda_ms(torch, lib_run, 20)
    ops = V * H * W * K5_OPS_PER_VIEW + H * W * K5_OPS_PER_PIXEL
    nbytes = 16 * H * W + 4 * V * H * W + 5 * V * H * W
    return [("warp", "warp/field", label, err, ms, plain,
             *bound_ms(ops, nbytes), lib_ms)]


def warp_ncc_rows(torch, ctx, ctx_r, planes, gt_plane):
    """The warp backend's NCC kernel (launch_warp_ncc) at 608x800, V=10,
    r=5, against its plain version: one ground-truth plane with the static
    radius's tap weights, and 17 perturbed planes (a FIRST_INIT batch) with
    the radius map's.  No one PyTorch call computes this function."""
    from dvpmvs_torch.kernels import warp_fused

    rows = []
    for label, c, pl in (("B=1, ground truth", ctx, gt_plane[None]),
                         ("B=17, perturbed, radius-map weights", ctx_r,
                          planes(17))):
        args = (pl.contiguous(), c.src_imgs, c.M, c.b, c.cam, c.src_wh,
                c.w_taps, c.wref_taps, c.sum_w, c.sum_wref, c.sum_wref2,
                c.strong_radius)
        got = warp_fused.warp_ncc(*args)
        want = warp_fused.warp_ncc_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"warp_ncc {label}: NaN at other entries "
                                 "than the plain version's")
        err = compare(torch, got, want, 1e-3, 1e-3, f"warp_ncc {label}")
        B = pl.shape[0]
        print(f"  warp_ncc {label}: cost < 2 at "
              f"{float((got < 2.0).float().mean()):.4f} of the entries",
              flush=True)
        ms = cuda_ms(torch, lambda: warp_fused.warp_ncc(*args), 10)
        plain = cuda_ms(torch, lambda: warp_fused.warp_ncc_plain(*args), 1)
        ops = B * H * W * (V * WARP_NCC_OPS_PER_VIEW + WARP_NCC_OPS_PER_PIXEL)
        nbytes = 4 * (4 * B * H * W + B * H * W * V + 72 * H * W + 3 * H * W
                      + V * H * W)
        rows.append(("warp_ncc", "warp/ncc", label, err, ms, plain,
                     *bound_ms(ops, nbytes), None))
    return rows


def k6_rows(torch, dev):
    """The seven K6 gather kernels at the JAX script's shapes (304x512
    pixels, 17 x 36 steps) against their plain versions, bit for bit; their
    launches are those of their own timing run.  Prints an empty launch's
    time at K6's grid (the launch floor) and beside each kernel its floor of
    the work as written, the pipe or wavefronts that set it and the SM
    clock sampled under its load (``gather_variants.floors``)."""
    from dvpmvs_torch.bench import gather_variants as gv
    from dvpmvs_torch.kernels import _build

    ins = gv.make_inputs(device=dev)
    Hd, Wd = ins[1].shape
    print(f"  gather_bench: {gv.empty_launch(Hd * Wd // gv.WARP)}: the "
          "launch floor", flush=True)
    rows, times = [], {}
    for variant in gv.VARIANTS:
        run = lambda: gv.run(variant, *ins)
        got = run()
        want = gv.run_plain(variant, *ins)
        torch.cuda.synchronize()
        err = float(torch.abs(got - want).max())
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        print(f"  gather_bench {variant}: max|d|={err:.3e}, bit for bit "
              f"{same} (required)", flush=True)
        if not same:
            raise AssertionError(f"gather_bench {variant}: kernel disagrees "
                                 "with its plain version")
        _build.reset_launches()
        ms = cuda_ms(torch, run, 20)
        launches = _build.MODE_LAUNCHES[f"gather_bench/{variant}"]
        times[variant] = ms
        plain = cuda_ms(torch, lambda: gv.run_plain(variant, *ins), 1)
        # steps the function needs per pixel: the f32 sums run all 17 x 36
        # in order; a wrapping int32 sum's 17 passes fold into one (times
        # 17), and prim_select keeps only the last tap's word
        steps = (gv.PV * gv.TAPS if variant in gv.FLOAT_VARIANTS else
                 1 if variant == "prim_select" else gv.TAPS)
        ops = Hd * Wd * steps * K6_OPS_PER_STEP[variant]
        nbytes = 4 * (2 * gv.TAPS + 3 * Hd * Wd + 64 * 256)
        rows.append(("gather_bench", f"gather_bench/{variant}",
                     f"{variant}, {Hd}x{Wd}", err, ms, plain,
                     *bound_ms(ops, nbytes), None, launches))
    for variant, f in gv.floors(ins, times).items():
        print("  gather_bench " + gv.report(variant, times[variant], f),
              flush=True)
    print(f"  gather_bench: quad8 {times['quad8']:.4f} ms vs p2x5 "
          f"{times['p2x5']:.4f} ms "
          f"({times['quad8'] / max(times['p2x5'], 1e-9):.2f}x)", flush=True)
    return rows


def acc2(depth, gt) -> float:
    import numpy as np
    d = depth[MARGIN:-MARGIN, MARGIN:-MARGIN]
    g = gt[MARGIN:-MARGIN, MARGIN:-MARGIN]
    rel = np.abs(d - g) / np.maximum(g, 1e-6)
    return float(((rel < 0.02) & (d > 0)).mean())


def counts():
    """Launch counts by kernel and, for K3, by mode."""
    from dvpmvs_torch.kernels import _build
    return {**_build.LAUNCHES, **_build.MODE_LAUNCHES}


def timed(torch, fn):
    """fn() on the card: (result, wall seconds, launches during it)."""
    torch.cuda.synchronize()
    before = counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = counts()
    return out, dt, {k: n - before.get(k, 0) for k, n in after.items()
                     if n - before.get(k, 0)}


def problem(torch, scene, v):
    """View v's 10 replicated source views, camera and Canny edge map."""
    from dvpmvs_torch.priors.edges import edge_segment
    nv = len(scene.cameras)
    others = [i for i in range(nv) if i != v]
    reps = [others[j % len(others)] for j in range(V)]
    edge = torch.as_tensor(edge_segment(0, scene.images[v], mode=0,
                                        use_canny=True) > 0)
    return reps, scene.cameras[v], edge


def first_init_views(torch, dev, scene, base, tag):
    """FIRST_INIT of round 0 on every view: {v: (out, seconds, acc2)} and
    the pass of view 0 as a callable."""
    from dvpmvs_torch.config import round_pass_params
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.rng import TorchDraws

    first, fn0, launches0 = {}, None, None
    for v in range(len(scene.cameras)):
        reps, cam, edge = problem(torch, scene, v)
        st, dyn = round_pass_params(0, 1, 0, base, float(cam.depth_min),
                                    float(cam.depth_max))
        fn = (lambda v=v, reps=reps, cam=cam, edge=edge, st=st, dyn=dyn:
              run_pass(scene.images[v], scene.images[reps], cam,
                       stack_cameras([scene.cameras[i] for i in reps]), st,
                       dyn, TorchDraws(v, dev), edge=edge, device=dev))
        out, dt, launches = timed(torch, fn)
        a = acc2(out.depth.cpu().numpy(), scene.gt_depth[v])
        print(f"  {tag}FIRST_INIT view {v}: {dt:.3f} s, acc2 {a:.4f}, "
              f"launches {launches}", flush=True)
        if not torch.isfinite(out.depth).all() or \
                tuple(out.depth.shape) != (H, W):
            raise AssertionError(f"FIRST_INIT view {v}: bad depth map")
        first[v] = (out, dt, a)
        if v == 0:
            fn0, launches0 = fn, launches
    return first, fn0, launches0


def require_launched(totals, names, what):
    for name in names:
        if totals.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on {what}")


def path_phase(torch, dev, scene):
    """FIRST_INIT on views 0-4, then REFINE_ITER on view 0 with and without
    the radius map, through run_pass with the fused backend."""
    from dvpmvs_torch.config import PMStatic, round_pass_params
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.rng import TorchDraws

    base = PMStatic(num_src=V, max_iterations=ITERS, cost_backend="fused")
    nv = len(scene.cameras)
    per_pass = {}
    passes = {}
    _build.reset_launches()
    first, passes["FIRST_INIT"], per_pass["FIRST_INIT"] = first_init_views(
        torch, dev, scene, base, "")
    out0, first_dt, first_acc = first[0]
    if first_acc < ACC2_FLOOR:
        raise AssertionError(f"FIRST_INIT acc2 {first_acc:.4f} < "
                             f"{ACC2_FLOOR}")

    reps, cam, edge = problem(torch, scene, 0)
    st_r, dyn_r = round_pass_params(0, 1, 1, base, float(cam.depth_min),
                                    float(cam.depth_max))
    src_depths = torch.stack([first[r][0].depth for r in reps])
    init_world = torch.cat([out0.normal_world, out0.depth[..., None]], -1)
    refine = {}
    for label, rmap in (("radius map", out0.radius), ("no radius map", None)):
        fn = (lambda rmap=rmap: run_pass(
            scene.images[0], scene.images[reps], cam,
            stack_cameras([scene.cameras[i] for i in reps]), st_r, dyn_r,
            TorchDraws(100, dev), init_plane_world=init_world,
            init_sel_views=out0.sel_views, init_weak=out0.weak,
            src_depths=src_depths, radius_map=rmap, edge=edge, device=dev))
        out, dt, launches = timed(torch, fn)
        a = acc2(out.depth.cpu().numpy(), scene.gt_depth[0])
        print(f"  REFINE_ITER view 0 ({label}): {dt:.3f} s, acc2 {a:.4f}, "
              f"launches {launches}", flush=True)
        if not torch.isfinite(out.depth).all():
            raise AssertionError(f"REFINE_ITER ({label}): non-finite depth")
        if a < ACC2_FLOOR:
            raise AssertionError(f"REFINE_ITER ({label}) acc2 {a:.4f} < "
                                 f"{ACC2_FLOOR}")
        refine[label] = (dt, a)
        per_pass[f"REFINE_ITER ({label})"] = launches
        passes[f"REFINE_ITER ({label})"] = fn
    totals = counts()
    require_launched(totals, ("ncc_fused", "sweep", "geom/fold",
                              "geom/per view"), "the round-0 path")
    warm = sorted(first[v][1] for v in range(1, nv))
    warm_s = warm[len(warm) // 2]
    summary = {
        "first_init_s": first_dt, "first_init_acc2": first_acc,
        "first_init_acc2_views": [first[v][2] for v in range(nv)],
        "first_init_s_views": [first[v][1] for v in range(nv)],
        "first_init_warm_median_s": warm_s,
        "first_init_view_pass_per_s": 1.0 / warm_s,
        "refine_radius_s": refine["radius map"][0],
        "refine_radius_acc2": refine["radius map"][1],
        "refine_s": refine["no radius map"][0],
        "refine_acc2": refine["no radius map"][1],
        "launches_per_pass": per_pass,
    }
    return totals, summary, passes, first


def region_mask(scene_kw):
    """The interior textureless region of view 0 (local variance < 1 in a
    7x7 window of the noise-free image, 6 px margin), as
    tests/test_weak_battery.py defines it."""
    from scipy.ndimage import uniform_filter
    from dvpmvs_torch.utils.synthetic import make_scene
    img = make_scene(num_views=1, height=H, width=W, **scene_kw).images[0]
    region = (uniform_filter(img ** 2, 7) - uniform_filter(img, 7) ** 2) < 1.0
    m = 6
    region[:m] = region[-m:] = region[:, :m] = region[:, -m:] = False
    return region


def region_acc2(depth, gt, region) -> float:
    import numpy as np
    rel = np.abs(depth - gt) / np.maximum(gt, 1e-6)
    return float(((rel < 0.02) & (depth > 0) & region).sum()
                 / max(int(region.sum()), 1))


def apd_chain(torch, dev, scene, first, tag, refine_init: bool,
              anchor_taps: int = 1, exact: bool = False):
    """The weak-pixel passes on view 0 from the FIRST_INIT outputs
    ``first``: REFINE_INIT of round 1 (if ``refine_init``), then REFINE_ITER
    in the JAX bench's configuration (bench.py:131-159: use_APD, geometric
    consistency against the other views' FIRST_INIT depths, no labels,
    3 iterations, edges) with ``anchor_taps``, or with the exact
    deformable oracle (``exact``).  Returns {label: (out, seconds, launches,
    callable, input weak count, acc2)}."""
    from dvpmvs_torch.config import (PixelState, PMDynamic, PMStatic,
                                     RunState, round_pass_params)
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.rng import TorchDraws

    reps, cam, edge = problem(torch, scene, 0)
    out0 = first[0][0]
    init = dict(init_plane_world=torch.cat(
        [out0.normal_world, out0.depth[..., None]], -1),
        init_sel_views=out0.sel_views, init_weak=out0.weak)
    src_cams = stack_cameras([scene.cameras[i] for i in reps])
    base = PMStatic(num_src=V, max_iterations=ITERS, cost_backend="fused")
    runs = []
    if refine_init:
        st, dyn = round_pass_params(1, 2, 0, base, float(cam.depth_min),
                                    float(cam.depth_max))
        runs.append(("REFINE_INIT (round 1)", st, dyn, {}))
    st = PMStatic(state=RunState.REFINE_ITER, num_src=V,
                  max_iterations=ITERS, cost_backend="fused", use_APD=True,
                  geom_consistency=True, use_label=False,
                  anchor_taps=anchor_taps, exact_deformable=exact)
    dyn = PMDynamic.create(depth_min=float(cam.depth_min),
                           depth_max=float(cam.depth_max))
    it_label = "REFINE_ITER (APD, geom" + (
        f", anchor_taps={anchor_taps}" if anchor_taps > 1 else "") + (
        ", exact_deformable" if exact else "") + ")"
    runs.append((it_label, st, dyn, dict(
        src_depths=torch.stack([first[r][0].depth for r in reps]))))
    result = {}
    for label, st, dyn, extra in runs:
        fn = (lambda st=st, dyn=dyn, extra=extra: run_pass(
            scene.images[0], scene.images[reps], cam, src_cams, st, dyn,
            TorchDraws(0, dev), edge=edge, device=dev, **init, **extra))
        out, dt, launches = timed(torch, fn)
        n_weak = int((out0.weak == PixelState.WEAK).sum())
        a = acc2(out.depth.cpu().numpy(), scene.gt_depth[0])
        over = (None if out.weak_overflow is None
                else int(out.weak_overflow))
        print(f"  {tag}{label} view 0: {dt:.3f} s, weak pixels {n_weak}, "
              f"weak_overflow {over}, acc2 {a:.4f}, launches {launches}",
              flush=True)
        if not torch.isfinite(out.depth).all() or \
                tuple(out.depth.shape) != (H, W):
            raise AssertionError(f"{label}: bad depth map")
        result[label] = (out, dt, launches, fn, n_weak, a)
    return result


def apd_phase(torch, dev, scene, first):
    """The weak-pixel passes on the bench scene (counted), then the same
    chain on a scene with a textureless band (its region's acc2)."""
    from dvpmvs_torch.config import PMStatic
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.utils.synthetic import make_scene

    _build.reset_launches()
    res = apd_chain(torch, dev, scene, first, "", refine_init=True)
    totals = counts()
    it_label = "REFINE_ITER (APD, geom)"
    a = res[it_label][5]
    if a < ACC2_FLOOR:
        raise AssertionError(f"{it_label} acc2 {a:.4f} < {ACC2_FLOOR}")
    for label, r in res.items():
        if r[4] <= 0:
            raise AssertionError(f"{label}: no weak pixel in the pass")
    require_launched(totals, ("anchor", "geom/parity", "ncc_fused"),
                     "the weak-pixel path")

    band_kw = dict(seed=6, weak_band=True)
    band = make_scene(num_views=5, height=H, width=W, **band_kw)
    region = region_mask(band_kw)
    base = PMStatic(num_src=V, max_iterations=ITERS, cost_backend="fused")
    band_first, _, _ = first_init_views(torch, dev, band, base, "band ")
    band_res = apd_chain(torch, dev, band, band_first, "band ",
                         refine_init=False)
    gt = band.gt_depth[0]
    before = region_acc2(band_first[0][0].depth.cpu().numpy(), gt, region)
    after = region_acc2(band_res[it_label][0].depth.cpu().numpy(), gt,
                        region)
    print(f"  band scene: textureless region {int(region.sum())} px, acc2 "
          f"{before:.4f} after FIRST_INIT, {after:.4f} after {it_label}",
          flush=True)
    summary = {
        label: {"s": r[1], "acc2": r[5], "weak_pixels": r[4],
                "weak_overflow": int(r[0].weak_overflow), "launches": r[2]}
        for label, r in res.items()}
    summary["band"] = {
        "region_px": int(region.sum()), "region_acc2_first_init": before,
        "region_acc2_refine_iter": after,
        "refine_iter_s": band_res[it_label][1],
        "weak_pixels": band_res[it_label][4],
        "acc2": band_res[it_label][5]}
    passes = {label: r[3] for label, r in res.items()}
    return (totals, summary, passes, band, band_first, before,
            band_res[it_label][3])


def warp_phase(torch, dev, scene, first, fused):
    """The "warp" cost backend on view 0: FIRST_INIT from random planes
    (acc2 printed, no floor), then REFINE_ITER from the "fused" FIRST_INIT
    outputs ``first`` in round 0's configuration (the radius map of view
    0's output, geometric consistency against the other views' depths).
    The warp NCC kernel must run once for every batch the backend
    evaluates and cost every plane it evaluates, K5 alone never, and K3's
    per-view mode must run in the sweeps.  ``fused``: the path phase's
    summary, whose REFINE_ITER (radius map) is printed beside the warp
    REFINE_ITER."""
    from dvpmvs_torch.config import PixelState, PMStatic, round_pass_params
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.kernels import _build, ncc, warp_fused
    from dvpmvs_torch.rng import TorchDraws

    base = PMStatic(num_src=V, max_iterations=ITERS, cost_backend="warp")
    reps, cam, edge = problem(torch, scene, 0)
    src_cams = stack_cameras([scene.cameras[i] for i in reps])
    out0 = first[0][0]
    lim = (float(cam.depth_min), float(cam.depth_max))
    st0, dyn0 = round_pass_params(0, 1, 0, base, *lim)
    st1, dyn1 = round_pass_params(0, 1, 1, base, *lim)
    runs = [
        ("FIRST_INIT (warp)", lambda: run_pass(
            scene.images[0], scene.images[reps], cam, src_cams, st0, dyn0,
            TorchDraws(0, dev), edge=edge, device=dev)),
        ("REFINE_ITER (warp, radius map, geom)", lambda: run_pass(
            scene.images[0], scene.images[reps], cam, src_cams, st1, dyn1,
            TorchDraws(100, dev), init_plane_world=torch.cat(
                [out0.normal_world, out0.depth[..., None]], -1),
            init_sel_views=out0.sel_views, init_weak=out0.weak,
            src_depths=torch.stack([first[r][0].depth for r in reps]),
            radius_map=out0.radius, edge=edge, device=dev)),
    ]
    _build.reset_launches()
    summary, passes = {}, {}
    for label, fn in runs:
        planes0 = ncc.PLANES_EVALUATED["warp"]
        batches0 = ncc.BATCHES_EVALUATED["warp"]
        kernel0 = warp_fused.KERNEL_PLANES["ncc"]
        out, dt, launches = timed(torch, fn)
        planes = ncc.PLANES_EVALUATED["warp"] - planes0
        batches = ncc.BATCHES_EVALUATED["warp"] - batches0
        kernel_planes = warp_fused.KERNEL_PLANES["ncc"] - kernel0
        a = acc2(out.depth.cpu().numpy(), scene.gt_depth[0])
        n_weak = int((out.weak == PixelState.WEAK).sum())
        n_ncc = launches.get("warp/ncc", 0)
        print(f"  {label} view 0: {dt:.3f} s, acc2 {a:.4f}, weak pixels out "
              f"{n_weak}, warp NCC launches {n_ncc} for {batches} batches "
              f"and {kernel_planes} of {planes} planes evaluated, launches "
              f"{launches}", flush=True)
        if not torch.isfinite(out.depth).all() or \
                tuple(out.depth.shape) != (H, W):
            raise AssertionError(f"{label}: bad depth map")
        if n_ncc != batches or kernel_planes != planes or planes <= 0:
            raise AssertionError(f"{label}: the warp NCC kernel ran {n_ncc} "
                                 f"times on {kernel_planes} planes for "
                                 f"{batches} batches of {planes} planes")
        if launches.get("warp/field", 0):
            raise AssertionError(f"{label}: K5 ran alone in the warp pass")
        summary[label] = {"s": dt, "acc2": a, "weak_pixels_out": n_weak,
                          "planes": planes, "batches": batches,
                          "launches": launches}
        passes[label] = fn
    label = runs[1][0]
    print(f"  REFINE_ITER view 0, same call: warp {summary[label]['s']:.3f} "
          f"s, acc2 {summary[label]['acc2']:.4f}; fused (radius map) "
          f"{fused['refine_radius_s']:.3f} s, acc2 "
          f"{fused['refine_radius_acc2']:.4f}", flush=True)
    if summary[label]["acc2"] < ACC2_FLOOR:
        raise AssertionError(f"{label} acc2 {summary[label]['acc2']:.4f} < "
                             f"{ACC2_FLOOR}")
    require_launched(summary[label]["launches"], ("geom/per view",), label)
    totals = counts()
    require_launched(totals, ("warp/ncc",), "the warp path")
    return totals, summary, passes


def taps_phase(torch, dev, scene, first, band, band_first, band_before,
               band_taps1):
    """The APD REFINE_ITER of bench.py's configuration with anchor_taps=3:
    on the bench scene (acc2 floor) and on the band scene (its region's
    acc2 beside the single-tap pass's)."""
    from dvpmvs_torch.kernels import _build

    _build.reset_launches()
    res = apd_chain(torch, dev, scene, first, "", refine_init=False,
                    anchor_taps=3)
    band_res = apd_chain(torch, dev, band, band_first, "band ",
                         refine_init=False, anchor_taps=3)
    totals = counts()
    (label, r), = res.items()
    if r[5] < ACC2_FLOOR:
        raise AssertionError(f"{label} acc2 {r[5]:.4f} < {ACC2_FLOOR}")
    if r[4] <= 0:
        raise AssertionError(f"{label}: no weak pixel in the pass")
    require_launched(totals, ("anchor/taps", "geom/parity"),
                     "the sparse-patch tap path")
    region = region_mask(dict(seed=6, weak_band=True))
    br = band_res[label]
    after = region_acc2(br[0].depth.cpu().numpy(), band.gt_depth[0], region)
    print(f"  band scene: textureless region acc2 {band_before:.4f} after "
          f"FIRST_INIT, {band_taps1:.4f} after the single-tap REFINE_ITER, "
          f"{after:.4f} with anchor_taps=3", flush=True)
    summary = {label: {"s": r[1], "acc2": r[5], "weak_pixels": r[4],
                       "weak_overflow": int(r[0].weak_overflow),
                       "launches": r[2]},
               "band": {"s": br[1], "acc2": br[5], "weak_pixels": br[4],
                        "region_acc2": after,
                        "region_acc2_single_tap": band_taps1}}
    return totals, summary, {label: r[3]}, br[3]


def device_profile(torch, fn):
    """One more run of ``fn`` under torch.profiler: (the device events'
    intervals in us, the device us by event name, the device's busy
    seconds -- the union of the intervals --, the run's wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return spans, by_name, busy * 1e-6, wall


def exact_phase(torch, dev, band, band_first, band_before, prod):
    """The exact deformable oracle at full width: one APD REFINE_ITER of
    the band scene's view 0 with ``exact_deformable=True`` from the band
    FIRST_INIT of the APD phase, beside the production passes from the same
    state (``prod``: {label: (callable, wall, acc2, region acc2)}, the
    single-tap pass of the APD phase and the ``anchor_taps=3`` pass of the
    taps phase).  Prints each pass's wall, device events and busy time (one
    more run under torch.profiler), acc2 and the textureless band's acc2;
    checks that K1 and K3 (per view: the exact weak half-iterations take
    the full grid, so no parity mode) were launched and K4 was not."""
    from dvpmvs_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.reset_launches()
    res = apd_chain(torch, dev, band, band_first, "band ", refine_init=False,
                    exact=True)
    totals = counts()
    (label, r), = res.items()
    require_launched(totals, ("ncc_fused", "geom/per view"),
                     "the exact oracle's pass")
    if totals.get("anchor", 0):
        raise AssertionError("K4 ran in the exact oracle's pass")
    if r[4] <= 0:
        raise AssertionError(f"{label}: no weak pixel in the pass")
    region = region_mask(dict(seed=6, weak_band=True))
    after = region_acc2(r[0].depth.cpu().numpy(), band.gt_depth[0], region)
    rows = {label: (r[3], r[1], r[5], after)}
    rows.update(prod)
    summary = {}
    for name, (fn, wall, a, ra) in rows.items():
        spans, _, busy, pwall = device_profile(torch, fn)
        events = len(spans)
        if events <= 0:
            raise AssertionError(f"{name}: the profiler saw no device event")
        summary[name] = {"s": wall, "acc2": a, "region_acc2": ra,
                         "device_events": events, "device_busy_s": busy,
                         "profiled_s": pwall}
        print(f"  band {name} view 0: wall {wall:.3f} s, device events "
              f"{events}, device busy {busy:.3f} s (profiled run "
              f"{pwall:.3f} s), acc2 {a:.4f}, textureless region acc2 "
              f"{ra:.4f} (FIRST_INIT {band_before:.4f})", flush=True)
    summary["launches"] = r[2]
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"  exact phase: {summary['phase_s']:.1f} s", flush=True)
    return totals, summary


def debug_phase(torch, dev, scene, scene_kw):
    """The debug outputs through SceneRunner on the card: the bench scene
    (5 views, made with ``scene_kw``) written to a folder; FIRST_INIT of
    every view, then the APD REFINE_ITER of view 0 (round 1's
    configuration), both with ``debug_dumps``; checks the three files' headers and sizes and that
    each cost curve's minimum lies within 2 steps of the solved depth's
    step (the center, 30) at >= 90 % of view 0's textured interior pixels
    with a depth.  Then ``show_medium_result`` over round 0 of a two-view
    folder, where PIL imports (the jpgs are PIL's)."""
    import importlib.util
    import tempfile
    from pathlib import Path

    import numpy as np
    from dvpmvs_torch.config import (PMStatic, SceneConfig,
                                     round_pass_params)
    from dvpmvs_torch.io import load_scene, read_bin_mat
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.rng import Rooted, fold_in
    from dvpmvs_torch.sched import SceneRunner
    from dvpmvs_torch.utils.synthetic import make_scene, write_scene_dir

    t_phase = time.perf_counter()
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        folder = write_scene_dir(scene, Path(tmp) / "dense")
        sc = load_scene(folder, max_src_views=V)
        base = PMStatic(max_iterations=ITERS, cost_backend="fused",
                        debug_dumps=True)
        runner = SceneRunner(sc, SceneConfig(), base, verbose=False,
                             device=dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        runner.run_schedule_pass(0, 0)
        torch.cuda.synchronize()
        summary["first_init_s"] = time.perf_counter() - t0
        res = sc.problems[0].result_folder
        raw = (res / "weak_ncc_cost.bin").read_bytes()
        head = np.frombuffer(raw[:12], np.int32).tolist()
        if head != [W, H, 61] or len(raw) != 12 + 4 * H * W * 61:
            raise AssertionError(f"weak_ncc_cost.bin: header {head}, "
                                 f"{len(raw)} bytes")
        curve = np.frombuffer(raw[12:], np.float32).reshape(H, W, 61)
        depth = runner.state[0].depth
        textured = ~region_mask(scene_kw)
        textured[:MARGIN] = textured[-MARGIN:] = False
        textured[:, :MARGIN] = textured[:, -MARGIN:] = False
        textured &= depth > 0
        near = np.abs(curve.argmin(-1) - 30) <= 2
        share = float(near[textured].mean())
        print(f"  debug FIRST_INIT (5 views): {summary['first_init_s']:.3f} "
              f"s; weak_ncc_cost.bin {len(raw)} bytes; the curve's minimum "
              f"within 2 steps of the solved depth at {share:.4f} of "
              f"{int(textured.sum())} textured pixels", flush=True)
        if share < 0.9:
            raise AssertionError(f"cost curves: minimum near the solved "
                                 f"depth at {share:.4f} < 0.9")
        st, dyn = round_pass_params(1, 2, 1, base, 0.0, 1.0)
        t0 = time.perf_counter()
        runner.run_view_pass(sc.problems[0], st, dyn, 1, Rooted(
            runner.draws, fold_in(fold_in((), 1), 0)))
        torch.cuda.synchronize()
        summary["refine_iter_s"] = time.perf_counter() - t0
        nmap = read_bin_mat(res / "neighbour_map.bin")
        raw = (res / "neighbour.bin").read_bytes()
        count, num = np.frombuffer(raw[:8], np.int32).tolist()
        if (nmap.shape != (H, W) or count != int((nmap >= 0).sum())
                or count <= 0 or num != 12
                or len(raw) != 8 + 4 * count * num):
            raise AssertionError(f"neighbour files: map {nmap.shape}, "
                                 f"header {count} x {num}, {len(raw)} bytes")
        launches = {k: n for k, n in counts().items() if n}
        print(f"  debug APD REFINE_ITER (view 0): "
              f"{summary['refine_iter_s']:.3f} s; neighbour.bin {count} "
              f"pixels x {num} entries; launches in the two passes "
              f"{launches}", flush=True)
        summary.update(curve_min_share=share, neighbour_pixels=count,
                       launches=launches)

        have_pil = importlib.util.find_spec("PIL") is not None
        summary["medium_results"] = have_pil
        if have_pil:
            two = write_scene_dir(make_scene(num_views=2, height=H, width=W,
                                             seed=2), Path(tmp) / "two")
            out = Path(tmp) / "medium"
            cfg = SceneConfig(show_medium_result=True,
                              output_folder=str(out))
            SceneRunner(load_scene(two), cfg, PMStatic(
                max_iterations=ITERS, cost_backend="fused"), verbose=False,
                device=dev).run()
            names = sorted(p.name for p in (out / "00000000").iterdir())
            want = sorted(f"{k}_{i}.jpg" for k in ("depths", "normals",
                                                   "weak") for i in range(4))
            if names != want:
                raise AssertionError(f"medium results: {names}")
            print(f"  medium results: {len(names)} jpgs a view", flush=True)
        else:
            print("  medium results: not run (PIL is not installed here; "
                  "the jpgs are PIL's)", flush=True)
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"  debug phase: {summary['phase_s']:.1f} s", flush=True)
    return summary


def weak_parts(torch, dev, scene, first):
    """The anchor search (once per pass) and the RANSAC fit (once per
    iteration) of the bench REFINE_ITER on their own, as callables for the
    profile: their share of the launch stream."""
    from dvpmvs_torch.geometry.transforms import plane_from_world
    from dvpmvs_torch.kernels.ncc import _grid
    from dvpmvs_torch.kernels.weak import (edge_complexity,
                                           edge_ray_distance, find_anchors,
                                           ransac_fit_plane)
    from dvpmvs_torch.rng import TorchDraws

    _, cam, edge = problem(torch, scene, 0)
    cam, edge = cam.to(dev), edge.to(dev)
    out0 = first[0][0]
    xs, ys = _grid(H, W, dev)
    plane = plane_from_world(torch.cat(
        [out0.normal_world, out0.depth[..., None]], -1), xs, ys, cam)
    cplx = edge_complexity(edge, 5)
    drange = float(cam.depth_max - cam.depth_min)
    search = lambda: find_anchors(out0.weak, plane, cam, TorchDraws(0, dev),
                                  (), rotate_time=4, edge=edge,
                                  complexity=cplx, depth_range=drange)
    anchors = search()
    edist = edge_ray_distance(edge)
    fit = lambda: ransac_fit_plane(anchors, plane, out0.weak, cam,
                                   TorchDraws(0, dev), (), use_radius=True,
                                   edge_dist=edist)
    return {"find_anchors (bench REFINE_ITER)": search,
            "ransac_fit_plane (one iteration)": fit}


def profile_phase(torch, passes):
    """One more run of each pass under torch.profiler: the device's busy
    time (the union of its kernel and copy intervals) against the pass's
    wall time, and the device time by kernel."""
    ours = {"ncc_fused_kernel": "ncc_fused", "sweep_kernel": "sweep",
            "geom_kernel": "geom", "anchor_kernel": "anchor",
            "warp_kernel": "warp", "warp_ncc_kernel": "warp_ncc"}
    result = {}
    for label, fn in passes.items():
        spans, by_name, busy, wall = device_profile(torch, fn)
        kernel_us = {k: 0.0 for k in ours.values()}
        for name, us in by_name.items():
            for tag, k in ours.items():
                if tag in name:
                    kernel_us[k] += us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        row = {"wall_s": wall, "device_busy_s": busy,
               "device_idle_share": 1.0 - busy / wall,
               "device_events": len(spans),
               "kernel_s": {k: us * 1e-6 for k, us in kernel_us.items()},
               "other_device_s": (sum(by_name.values())
                                  - sum(kernel_us.values())) * 1e-6,
               "top": [[n[:60], us * 1e-6] for n, us in top]}
        print(f"  {label}: {json.dumps(row)}", flush=True)
        result[label] = row
    return result


SCENE_VIEWS = 11             # 10 sources per problem: the V of the phases


def scene_phase(torch):
    """The scene command on the card: an 11-view 608x800 synthetic scene
    (make_scene seed 2) written with write_scene_dir to a temporary folder,
    then ``dvpmvs_torch.cli.run scene <folder> --checkpoint --metrics`` in
    this process with its defaults (the card, the fused backend, 3
    iterations, 3 geometric passes, 10 sources): round 0 only at <= 800
    px, 11 views x 4 passes, then ETH3D fusion of 11 x 10 pairs to
    APD.ply.  Checks the launches of K1, K2 and K3 (per view) in the run,
    each view's acc2 (view 0 at least ACC2_FLOOR), the PLY read back,
    the checkpoint files, and that a resumed run runs no pass and writes
    the same PLY.  Also times the Canny prior on the host."""
    import tempfile
    from pathlib import Path

    import numpy as np
    from dvpmvs_torch.cli.run import main as cli
    from dvpmvs_torch.io import read_dmb, read_ply
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.priors.edges import edge_segment
    from dvpmvs_torch.sched import runner as runner_mod
    from dvpmvs_torch.utils.synthetic import make_scene, write_scene_dir

    t_phase = time.perf_counter()
    scene = make_scene(num_views=SCENE_VIEWS, height=H, width=W, seed=2)
    canny = []
    for v in range(3):
        t0 = time.perf_counter()
        edge_segment(0, scene.images[v], mode=0, use_canny=True)
        canny.append(time.perf_counter() - t0)
    canny_s = sorted(canny)[1]
    print(f"  Canny edge prior (host, {H}x{W}): median of 3 {canny_s:.4f} s "
          f"({', '.join(f'{c:.4f}' for c in canny)})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        folder = write_scene_dir(scene, Path(tmp) / "dense")
        out = folder / "APD"
        argv = ["scene", str(folder), "--checkpoint", "--metrics"]
        # the time inside run_pass, so that the rest of a pass wall is the
        # runner's host work (resizes, edges, visibility cleanup, copies)
        inner = []

        def timed_pass(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run_pass(*args, **kw)
            torch.cuda.synchronize()
            inner.append(time.perf_counter() - t)
            return out

        run_pass = runner_mod.run_pass
        runner_mod.run_pass = timed_pass
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            cli(argv)
        finally:
            runner_mod.run_pass = run_pass
        torch.cuda.synchronize()
        scene_s = time.perf_counter() - t0
        launches = {k: n for k, n in counts().items() if n}
        # K3's fold runs only in a sweep without a radius map; the runner
        # passes each view's radius map to its REFINE_ITER, as the
        # reference does, so its sweeps take K3's per-view mode
        require_launched(launches, ("ncc_fused", "sweep", "geom/per view"),
                         "the scene run")
        metrics = json.loads((out / "metrics.json").read_text())["timings"]
        walls = {k: v["total_s"] for k, v in metrics.items()}
        expect = [f"round0/pass{i}" for i in range(4)] + ["fusion"]
        if sorted(walls) != sorted(expect):
            raise AssertionError(f"scene run spans {sorted(walls)}")
        accs = []
        for v in range(SCENE_VIEWS):
            d = out / f"{v:08d}"
            for name in ("depths.dmb", "depths_geom.dmb", "weak.png"):
                if not (d / name).exists():
                    raise AssertionError(f"view {v}: no {name}")
            accs.append(acc2(read_dmb(d / "depths_geom.dmb"),
                             scene.gt_depth[v]))
        if not (out / "progress.json").exists():
            raise AssertionError("no progress.json")
        pts, cols = read_ply(out / "APD.ply")
        if len(pts) == 0 or not np.isfinite(pts).all():
            raise AssertionError(f"APD.ply: {len(pts)} points")
        dist = np.abs(pts.astype(np.float64) @ scene.planes_n.T
                      + scene.planes_d[None]).min(1)
        on_plane = float((dist < 0.06).mean())
        print(f"  scene run: {scene_s:.2f} s, passes "
              + ", ".join(f"{k} {walls[k]:.3f} s" for k in expect[:4])
              + f", fusion {walls['fusion']:.3f} s; {len(pts)} points, "
              f"{on_plane:.4f} within 0.06 of a ground-truth plane; "
              f"launches {launches}", flush=True)
        print("  acc2 by view: " + ", ".join(f"{a:.4f}" for a in accs),
              flush=True)
        in_pass = [sum(inner[i * SCENE_VIEWS:(i + 1) * SCENE_VIEWS])
                   for i in range(4)]
        print("  inside run_pass by pass: "
              + ", ".join(f"{t:.3f} s" for t in in_pass)
              + f"; view passes median {sorted(inner)[len(inner) // 2]:.3f}"
              f" s; the runner's host work "
              + ", ".join(f"{walls[k] - t:.3f} s"
                          for k, t in zip(expect, in_pass)), flush=True)
        if accs[0] < ACC2_FLOOR:
            raise AssertionError(f"scene view 0 acc2 {accs[0]:.4f} < "
                                 f"{ACC2_FLOOR}")
        ply = (out / "APD.ply").read_bytes()
        _build.reset_launches()
        t0 = time.perf_counter()
        cli(argv[:2] + ["--resume", "--metrics"])
        resume_s = time.perf_counter() - t0
        resumed = json.loads((out / "metrics.json").read_text())["timings"]
        if sorted(resumed) != ["fusion"]:
            raise AssertionError(f"the resumed run ran {sorted(resumed)}")
        if (out / "APD.ply").read_bytes() != ply:
            raise AssertionError("the resumed run wrote another APD.ply")
        print(f"  resumed: no pass, the same APD.ply, {resume_s:.2f} s",
              flush=True)
    summary = {"views": SCENE_VIEWS, "scene_s": scene_s, "pass_s": walls,
               "run_pass_s": in_pass, "view_pass_s": inner,
               "points": int(len(pts)), "on_plane_share": on_plane,
               "acc2_views": accs, "canny_host_s": canny_s,
               "canny_host_s_runs": canny, "resume_s": resume_s,
               "launches": launches,
               "phase_s": time.perf_counter() - t_phase}
    print(f"  scene phase: {summary['phase_s']:.1f} s", flush=True)
    return launches, summary


def rounds_phase(torch):
    """Rounds >= 1 of a scene on the card, with both priors: an 11-view
    608x800 folder (make_scene seed 2) written with its sfm/ points; the
    CLI's ``prior`` command in this process (DA-V2 ViT-S, random weights
    from seed 0, each view padded to 616x812: 2,552 patch tokens), timed
    per view; the label maps' host time at scales 0 and 1; then ``scene
    --mono-prior --max-base-size 400 --full-res-round --checkpoint
    --metrics``: round 0 at 304x400 (FIRST_INIT from the mono planes, 3
    REFINE_ITER), round 1 at 608x800 (REFINE_INIT, 3 APD REFINE_ITER with
    computed label maps), ETH3D fusion.  Checks the dep/ maps, the launches
    of K1, K2, K3 (per view, parity) and K4 in the run, the 8 pass spans,
    acc2 of each view at 608x800 (view 0 at least ACC2_FLOOR) and the
    fused cloud."""
    import tempfile
    from pathlib import Path

    import numpy as np
    from dvpmvs_torch.cli.run import main as cli
    from dvpmvs_torch.io import read_dmb, read_ply
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.priors import depth_anything as da
    from dvpmvs_torch.priors.edges import edge_segment
    from dvpmvs_torch.sched import runner as runner_mod
    from dvpmvs_torch.utils.synthetic import make_scene, write_scene_dir

    t_phase = time.perf_counter()
    scene = make_scene(num_views=SCENE_VIEWS, height=H, width=W, seed=2)
    labels = {}
    for scale in (0, 1):
        runs_s = []
        for v in range(3):
            t0 = time.perf_counter()
            edge_segment(scale, scene.images[v], mode=1, use_canny=False)
            runs_s.append(time.perf_counter() - t0)
        labels[scale] = sorted(runs_s)[1]
        print(f"  label map (host, {H}x{W}, scale {scale}): median of 3 "
              f"{labels[scale]:.4f} s ({', '.join(f'{t:.4f}' for t in runs_s)}"
              ")", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        folder = write_scene_dir(scene, Path(tmp) / "dense", with_sfm=True)
        da_s, n_params = [], []
        infer = da.infer_relative_depth

        def timed_infer(model, img):
            n_params.append(sum(p.numel() for p in model.parameters()))
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = infer(model, img)
            torch.cuda.synchronize()
            da_s.append(time.perf_counter() - t)
            return out

        da.infer_relative_depth = timed_infer
        try:
            cli(["prior", str(folder), "--seed", "0"])
        finally:
            da.infer_relative_depth = infer
        deps = sorted((folder / "dep").glob("*.dmb"))
        if len(deps) != SCENE_VIEWS:
            raise AssertionError(f"prior wrote {len(deps)} dep/ maps")
        for d in deps:
            m = read_dmb(d)
            if m.shape != (H, W) or not np.isfinite(m).all():
                raise AssertionError(f"{d.name}: bad map {m.shape}")
        da_view = float(np.median(da_s[1:]))
        print(f"  DA-V2 ViT-S prior ({n_params[0]:,} parameters, {H}x{W} "
              f"padded to {-(-H // 14) * 14}x{-(-W // 14) * 14}): first view "
              f"{da_s[0]:.4f} s, median of the other {len(da_s) - 1} "
              f"{da_view:.4f} s", flush=True)

        out = folder / "APD"
        # a base size of half the width: round 0 at half size, round 1 at
        # full size
        argv = ["scene", str(folder), "--mono-prior", "--max-base-size",
                str(W // 2), "--full-res-round", "--checkpoint", "--metrics"]
        inner, label_s, labelled = [], [], []

        def timed_pass(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run_pass(*args, **kw)
            torch.cuda.synchronize()
            inner.append(time.perf_counter() - t)
            return res

        def timed_edges(scale, img, mode, use_canny=False):
            t = time.perf_counter()
            res = segment(scale, img, mode, use_canny)
            if mode == 1:
                label_s.append(time.perf_counter() - t)
                labelled.append(float((res > 0).mean()))
            return res

        run_pass, segment = runner_mod.run_pass, runner_mod.edge_segment
        runner_mod.run_pass, runner_mod.edge_segment = timed_pass, \
            timed_edges
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            cli(argv)
        finally:
            runner_mod.run_pass, runner_mod.edge_segment = run_pass, segment
        torch.cuda.synchronize()
        scene_s = time.perf_counter() - t0
        launches = {k: n for k, n in counts().items() if n}
        require_launched(launches, ("ncc_fused", "sweep", "geom/per view",
                                    "geom/parity", "anchor"),
                         "the rounds scene run")
        dump = json.loads((out / "metrics.json").read_text())
        walls = {k: v["total_s"] for k, v in dump["timings"].items()}
        spans = [f"round{r}/pass{i}" for r in (0, 1) for i in range(4)]
        if sorted(walls) != sorted(spans + ["fusion"]):
            raise AssertionError(f"rounds run spans {sorted(walls)}")
        overflow = int(dump["counters"].get("weak_budget_overflow_px", 0))
        if len(label_s) != SCENE_VIEWS:
            raise AssertionError(f"{len(label_s)} label maps computed")
        accs = []
        for v in range(SCENE_VIEWS):
            d = read_dmb(out / f"{v:08d}" / "depths_geom.dmb")
            if d.shape != (H, W):
                raise AssertionError(f"view {v}: depth {d.shape}")
            accs.append(acc2(d, scene.gt_depth[v]))
        pts, _ = read_ply(out / "APD.ply")
        if len(pts) == 0 or not np.isfinite(pts).all():
            raise AssertionError(f"APD.ply: {len(pts)} points")
        dist = np.abs(pts.astype(np.float64) @ scene.planes_n.T
                      + scene.planes_d[None]).min(1)
        on_plane = float((dist < 0.06).mean())
    in_pass = [sum(inner[i * SCENE_VIEWS:(i + 1) * SCENE_VIEWS])
               for i in range(len(spans))]
    print(f"  rounds run: {scene_s:.2f} s; "
          + ", ".join(f"{k} {walls[k]:.3f} s" for k in spans)
          + f", fusion {walls['fusion']:.3f} s; {len(pts)} points, "
          f"{on_plane:.4f} within 0.06 of a ground-truth plane; "
          f"launches {launches}", flush=True)
    print("  inside run_pass by pass: "
          + ", ".join(f"{t:.3f} s" for t in in_pass)
          + "; the runner's host work "
          + ", ".join(f"{walls[k] - t:.3f} s" for k, t in zip(spans, in_pass))
          + f"; of it the label maps {sum(label_s):.3f} s (median "
          f"{float(np.median(label_s)):.4f} s a view; labelled regions "
          f"cover {min(labelled):.4f}-{max(labelled):.4f} of a view); "
          f"weak_budget_overflow_px {overflow}", flush=True)
    print("  acc2 by view (608x800, after round 1): "
          + ", ".join(f"{a:.4f}" for a in accs), flush=True)
    if accs[0] < ACC2_FLOOR:
        raise AssertionError(f"rounds view 0 acc2 {accs[0]:.4f} < "
                             f"{ACC2_FLOOR}")
    summary = {"views": SCENE_VIEWS, "scene_s": scene_s, "pass_s": walls,
               "run_pass_s": in_pass, "view_pass_s": inner,
               "label_run_s": label_s, "label_host_s": labels,
               "labelled_share": labelled,
               "da_view_s": da_view, "da_s": da_s,
               "da_params": n_params[0], "weak_budget_overflow_px": overflow,
               "points": int(len(pts)), "on_plane_share": on_plane,
               "acc2_views": accs, "launches": launches,
               "phase_s": time.perf_counter() - t_phase}
    print(f"  rounds phase: {summary['phase_s']:.1f} s", flush=True)
    return launches, summary


DIST_GEOM_PASSES = 3         # round 0: FIRST_INIT and 3 REFINE_ITER
DIST_MH_GEOM_PASSES = 1      # the multi-host runs: FIRST_INIT, 1 REFINE_ITER


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dist_base():
    from dvpmvs_torch.config import PMStatic
    return PMStatic(max_iterations=ITERS, cost_backend="fused")


def dist_scene_rank(mesh, folder, out, geometric_passes):
    """One rank of the batched round-0 schedule (mesh_views=2) on the card,
    checkpointing into ``out`` (rank 0 writes): its wall, the pass walls,
    its own launch counts and the share of its view passes."""
    import torch
    import torch.distributed as dist
    from dvpmvs_torch.config import SceneConfig
    from dvpmvs_torch.io import load_scene
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.sched import SceneRunner

    runner = SceneRunner(load_scene(folder, max_src_views=V),
                         SceneConfig(geometric_passes=geometric_passes,
                                     mesh_views=2),
                         _dist_base(), verbose=mesh.rank == 0,
                         device=mesh.device, group=mesh.group)
    _sync(torch, mesh.device)
    _build.reset_launches()
    t0 = time.perf_counter()
    runner.run(checkpoint_dir=out)
    _sync(torch, mesh.device)
    return {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
            "backend": (None if mesh.group is None
                        else dist.get_backend(mesh.group)),
            "wall_s": time.perf_counter() - t0,
            "pass_s": {k: v["total_s"] for k, v in
                       runner.metrics.summary()["timings"].items()},
            "launches": {k: n for k, n in counts().items() if n}}


def dist_multihost_rank(mesh, folder, sync_dir):
    """One host of a two-host MultiHostRunner round 0 on the card (file
    sync through ``sync_dir``, or the collective exchange when None): every
    view's depth as this host holds it, and its wall."""
    import torch
    from dvpmvs_torch.config import SceneConfig
    from dvpmvs_torch.dist.multihost import MultiHostRunner
    from dvpmvs_torch.io import load_scene

    runner = MultiHostRunner(
        load_scene(folder, max_src_views=V),
        SceneConfig(geometric_passes=DIST_MH_GEOM_PASSES), _dist_base(),
        checkpoint_dir=sync_dir, group=mesh.group, verbose=False,
        device=mesh.device)
    t0 = time.perf_counter()
    runner.run(checkpoint_dir=sync_dir)
    _sync(torch, mesh.device)
    return {"wall_s": time.perf_counter() - t0,
            "owned": sorted(p.ref_image_id for p in runner.scene.problems),
            "depths": {v: st.depth for v, st in runner.state.items()}}


def dist_phase(torch, card="cuda:0", nccl="nccl"):
    """The view-sharded scene run on the card: the scene phase's folder (11
    views, 608x800, V=10), round 0 (FIRST_INIT and 3 REFINE_ITER, the fused
    backend), through the port's batched schedule (mesh_views=2):
    (a) in this process, no process group; (b) two ranks, each a process of
    its own (dvpmvs_torch.dist.launch): both on cuda:0 with gloo (state
    exchanged through the host) on a one-card machine, NCCL on cuda:0 and
    cuda:1 where there are two cards; (c) one rank in an NCCL group, so
    that the NCCL code path runs on the card.  Checks that every view's
    depths_geom.dmb in (b) and (c) equals (a) bit for bit (if not, it runs
    (a) again: a run that differs from itself is reported, with the share
    of pixels within 1e-4, as the pass's nondeterminism, and is not a
    failure; one that equals itself is), that K1, K2 and K3 (per view)
    were launched in every rank, view 0's acc2, and run_fusion_sharded on
    (a)'s state against the serial run_fusion (its points at 0.6-1.1 of
    the serial count, as many on a ground-truth plane) and its pair fields
    on the card against the CPU's (view 0's 10 pairs: nearest pixels,
    validity and the eth3d support test equal almost everywhere, err and
    rdd within 1e-4 and 1e-6, the angle within 4 ulps of its cosine).
    Then a
    two-host MultiHostRunner round 0 (FIRST_INIT, one REFINE_ITER) on
    cuda:0 with gloo, with the file sync and with the collective exchange:
    both give every view the same depth.  Prints each run's wall and pass
    walls."""
    import tempfile
    from pathlib import Path

    import numpy as np
    from dvpmvs_torch.dist import launch, make_mesh
    from dvpmvs_torch.fusion import run_fusion, run_fusion_sharded
    from dvpmvs_torch.fusion.fuse import _all_pairs_consistency
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.io import load_scene, read_dmb
    from dvpmvs_torch.sched import SceneRunner
    from dvpmvs_torch.utils.synthetic import make_scene, write_scene_dir

    t_phase = time.perf_counter()
    scene = make_scene(num_views=SCENE_VIEWS, height=H, width=W, seed=2)
    n_cards = torch.cuda.device_count()
    summary = {"cards": n_cards, "views": SCENE_VIEWS,
               "geometric_passes": DIST_GEOM_PASSES}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        folder = write_scene_dir(scene, tmp / "dense")

        def depths(out):
            return {v: read_dmb(out / f"{v:08d}" / "depths_geom.dmb")
                    for v in range(SCENE_VIEWS)}

        def in_process(tag):
            t0 = time.perf_counter()
            res = dist_scene_rank(make_mesh(None, card), folder,
                                  tmp / tag, DIST_GEOM_PASSES)
            res["launch_s"] = time.perf_counter() - t0
            return res

        def ranks(tag, n, devices, backend):
            t0 = time.perf_counter()
            res = launch(dist_scene_rank, n,
                         (str(folder), str(tmp / tag), DIST_GEOM_PASSES),
                         workdir=tmp / f"{tag}_work", devices=devices,
                         backend=backend)
            for r in res:
                r["launch_s"] = time.perf_counter() - t0
            return res

        def report(tag, res):
            for r in res:
                print(f"  ({tag}) rank {r['rank']}/{r['size']} on "
                      f"{r['device']} ({r['backend'] or 'no group'}): "
                      f"run {r['wall_s']:.2f} s (with start-up "
                      f"{r['launch_s']:.2f} s), passes "
                      + ", ".join(f"{k} {t:.3f} s"
                                  for k, t in r["pass_s"].items())
                      + f"; launches {r['launches']}", flush=True)
                require_launched(r["launches"],
                                 ("ncc_fused", "sweep", "geom/per view"),
                                 f"dist run ({tag}) rank {r['rank']}")
            return res

        runs = {"a": report("a", [in_process("a")])}
        two = (["cuda:0", "cuda:1"], nccl) if n_cards >= 2 else \
            ([card, card], "gloo")
        runs["b"] = report("b", ranks("b", 2, *two))
        runs["c"] = report("c", ranks("c", 1, [card], nccl))
        want = depths(tmp / "a")
        accs = [acc2(want[v], scene.gt_depth[v]) for v in range(SCENE_VIEWS)]
        print("  (a) acc2 by view: " + ", ".join(f"{a:.4f}" for a in accs),
              flush=True)
        if accs[0] < ACC2_FLOOR:
            raise AssertionError(f"dist view 0 acc2 {accs[0]:.4f} < "
                                 f"{ACC2_FLOOR}")

        def share_1e4(got):
            return min(float((np.abs(got[v] - want[v])
                              <= 1e-4 * np.abs(want[v])).mean())
                       for v in want)

        equal = {}
        for tag in ("b", "c"):
            got = depths(tmp / tag)
            equal[tag] = all(np.array_equal(got[v], want[v]) for v in want)
            print(f"  ({tag}) depths_geom.dmb equal to (a) bit for bit: "
                  f"{equal[tag]} (least share within 1e-4 "
                  f"{share_1e4(got):.6f})", flush=True)
        summary["bitwise_equal"] = equal
        if not all(equal.values()):
            again = in_process("a2")
            got = depths(tmp / "a2")
            self_equal = all(np.array_equal(got[v], want[v]) for v in want)
            summary["a_again_equal"] = self_equal
            summary["a_again_share_1e-4"] = share_1e4(got)
            print(f"  (a) again: equal to itself {self_equal} (least share "
                  f"within 1e-4 {share_1e4(got):.6f}; run "
                  f"{again['wall_s']:.2f} s)", flush=True)
            if self_equal:
                raise AssertionError("the rank runs differ from the "
                                     "one-process run, which is "
                                     "deterministic")

        # fusion: sharded (one batch of all pairs) against the serial greedy
        one = SceneRunner(load_scene(folder, max_src_views=V),
                          base_static=_dist_base(), verbose=False,
                          device=card)
        one.load_checkpoint(tmp / "a")
        inputs = one.fusion_inputs()
        _sync(torch, card)
        t0 = time.perf_counter()
        pts_s, _ = run_fusion_sharded(inputs, "eth3d", device=card)
        _sync(torch, card)
        sharded_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pts, _ = run_fusion(inputs, "eth3d", device=card)
        serial_s = time.perf_counter() - t0
        on = [float((np.abs(p.astype(np.float64) @ scene.planes_n.T
                            + scene.planes_d[None]).min(1) < 0.06).mean())
              for p in (pts_s, pts)]
        ratio = len(pts_s) / max(len(pts), 1)
        print(f"  fusion of (a): sharded {len(pts_s)} points in "
              f"{sharded_s:.3f} s, serial {len(pts)} points in "
              f"{serial_s:.3f} s (ratio {ratio:.4f}); within 0.06 of a "
              f"ground-truth plane {on[0]:.4f} and {on[1]:.4f}", flush=True)
        # the ownership rule's documented deviation grows with the sources
        # a view has: JAX's own sharded cloud is 0.79-0.85 of its serial
        # one at 11 views on the CPU (tests/test_torch_dist.py)
        if not (len(pts) and 0.6 <= ratio <= 1.1 and on[0] >= on[1] - 0.05):
            raise AssertionError(f"sharded fusion {len(pts_s)} points "
                                 f"({on[0]:.4f} on a plane), serial "
                                 f"{len(pts)} ({on[1]:.4f})")
        # the card's pair fields against the CPU's, view 0's 10 pairs
        # (the bounds of tests/test_torch_scene.py's pair test)
        ids = [p.ref_image_id for p in inputs.problems]
        sidx = np.asarray([[ids.index(sv) for sv in p.src_image_ids]
                           for p in inputs.problems], np.int32)

        def fields(dev):
            d = torch.stack([torch.as_tensor(inputs.depths[r]) for r in ids])
            n = torch.stack([torch.as_tensor(inputs.normals[r])
                             for r in ids])
            c = stack_cameras([inputs.cameras[r] for r in ids]).to(dev)
            return [f.cpu().numpy() for f in _all_pairs_consistency(
                d.to(dev), n.to(dev), c, sidx, c, slice(0, 1))]

        got, want = fields(card), fields("cpu")
        same = (got[3] == want[3]) & (got[4] == want[4])
        valid_eq = float((got[5] == want[5]).mean())
        errs = [float(np.abs(got[k] - want[k])[same].max()) for k in range(3)]
        # the eth3d support test of each (pair, pixel): the decision the
        # fusion takes from the fields
        support = [f[5] & (f[0] < 2.0) & (f[1] < 0.01) & (f[2] < 0.174533)
                   for f in (got, want)]
        support_eq = float((support[0] == support[1]).mean())
        print(f"  pair fields of view 0 (10 pairs), card against CPU: "
              f"indices equal at {same.mean():.6f}, validity at "
              f"{valid_eq:.6f}, eth3d support at {support_eq:.7f}; max |d| "
              f"err {errs[0]:.2e}, rdd {errs[1]:.2e}, angle {errs[2]:.2e}",
              flush=True)
        # the angle is the arccos of a float32 cosine, whose sums and roots
        # the card and the CPU round apart: near a cosine of 1, k ulps
        # (2^-24) of it move the angle by sqrt(2 k 2^-24) = 3.45e-4
        # sqrt(k); the bound allows 4 ulps
        if not (same.mean() >= 0.999 and valid_eq >= 0.999
                and support_eq >= 0.9999 and errs[0] <= 1e-4
                and errs[1] <= 1e-6 and errs[2] <= 7e-4):
            raise AssertionError("the card's pair fields disagree with the "
                                 "CPU's")

        # two hosts on cuda:0 (gloo): file sync, then the collective
        mh = {}
        for tag, sync in (("files", str(tmp / "mh_ckpt")),
                          ("collective", None)):
            t0 = time.perf_counter()
            mh[tag] = launch(dist_multihost_rank, 2, (str(folder), sync),
                             workdir=tmp / f"mh_{tag}",
                             devices=[card, card], backend="gloo")
            print(f"  multi-host ({tag}): runs "
                  + ", ".join(f"{r['wall_s']:.2f} s" for r in mh[tag])
                  + f", with start-up {time.perf_counter() - t0:.2f} s; "
                  f"owned {[r['owned'] for r in mh[tag]]}", flush=True)
        for f, c in zip(mh["files"], mh["collective"]):
            for v, d in f["depths"].items():
                if not np.array_equal(d, c["depths"][v]):
                    raise AssertionError(f"multi-host view {v}: the file "
                                         f"sync and the collective differ")
        print("  multi-host: the file sync and the collective give every "
              "view the same depth", flush=True)
    summary.update({
        "runs": {k: [{x: r[x] for x in ("rank", "device", "backend",
                                        "wall_s", "launch_s", "pass_s",
                                        "launches")} for r in v]
                 for k, v in runs.items()},
        "acc2_views": accs, "fusion_sharded_points": int(len(pts_s)),
        "fusion_serial_points": int(len(pts)), "fusion_on_plane": on,
        "pair_fields_card_cpu": {"indices_equal": float(same.mean()),
                                 "valid_equal": valid_eq,
                                 "support_equal": support_eq,
                                 "max_abs_err_rdd_angle": errs},
        "fusion_sharded_s": sharded_s, "fusion_serial_s": serial_s,
        "multihost_s": {k: [r["wall_s"] for r in v] for k, v in mh.items()},
        "phase_s": time.perf_counter() - t_phase})
    print(f"  dist phase: {summary['phase_s']:.1f} s", flush=True)
    return summary


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.utils.synthetic import make_scene

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in _build.SOURCES:
        print(f"  {name} ({_build.flags(name)[-1]}), -Xptxas -v:", flush=True)
        for line in _build.ptxas_report(name):
            print(f"    {line}", flush=True)
    dev = torch.device("cuda")
    if "--dist-only" in sys.argv[1:]:
        # development: the dist phase alone (no kernel rows, no result line)
        print(json.dumps({"path": {"dist": dist_phase(torch)}}), flush=True)
        print(card_line(), flush=True)
        return 0

    scene = make_scene(num_views=5, height=H, width=W, seed=2)
    reps0 = [[1, 2, 3, 4][j % 4] for j in range(V)]
    print("kernel phase (kernel vs plain on the card):", flush=True)
    rows = kernel_phase(torch, dev, scene, reps0)
    print("path phase, round 0 (fused backend, 608x800, V=10):", flush=True)
    runs = {}
    runs["round0"], summary, passes, first = path_phase(torch, dev, scene)
    print("path phase, weak-pixel passes (fused backend, 608x800, V=10):",
          flush=True)
    (runs["apd"], summary["apd"], apd_passes, band, band_first,
     band_before, band_apd) = apd_phase(torch, dev, scene, first)
    passes.update(apd_passes)
    print("path phase, the warp cost backend (608x800, V=10):", flush=True)
    runs["warp"], summary["warp"], warp_passes = warp_phase(
        torch, dev, scene, first, summary)
    passes.update(warp_passes)
    print("path phase, sparse-patch taps (anchor_taps=3, fused backend):",
          flush=True)
    runs["taps"], summary["taps"], taps_passes, band_taps = taps_phase(
        torch, dev, scene, first, band, band_first, band_before,
        summary["apd"]["band"]["region_acc2_refine_iter"])
    passes.update(taps_passes)
    print("exact phase (the exact deformable oracle, band scene, fused "
          "backend):", flush=True)
    b1, bt = summary["apd"]["band"], summary["taps"]["band"]
    runs["exact"], summary["exact"] = exact_phase(
        torch, dev, band, band_first, band_before, {
            "REFINE_ITER (APD, geom)": (
                band_apd, b1["refine_iter_s"], b1["acc2"],
                b1["region_acc2_refine_iter"]),
            "REFINE_ITER (APD, geom, anchor_taps=3)": (
                band_taps, bt["s"], bt["acc2"], bt["region_acc2"])})
    print("debug phase (debug_dumps and show_medium_result through "
          "SceneRunner):", flush=True)
    summary["debug"] = debug_phase(torch, dev, scene, dict(seed=2))
    print("kernel phase, K4 at the bench scene's own compaction:", flush=True)
    rows += k4_path_rows(torch, dev, scene, first)
    print(f"scene phase (the scene command, {SCENE_VIEWS} views, {H}x{W}, "
          f"V={V}, round 0, ETH3D fusion):", flush=True)
    runs["scene"], summary["scene"] = scene_phase(torch)
    print(f"rounds phase (the prior and scene --mono-prior commands, "
          f"{SCENE_VIEWS} views, round 0 at {H // 2}x{W // 2}, round 1 at "
          f"{H}x{W}, V={V}, label maps, ETH3D fusion):", flush=True)
    runs["rounds"], summary["rounds"] = rounds_phase(torch)
    print(f"dist phase (the batched schedule over ranks, {SCENE_VIEWS} "
          f"views, {H}x{W}, V={V}, round 0; MultiHostRunner; sharded "
          f"fusion):", flush=True)
    summary["dist"] = dist_phase(torch)
    if "--profile" in sys.argv[1:]:
        print("profile phase (torch.profiler, one run of each pass):",
              flush=True)
        passes.update(weak_parts(torch, dev, scene, first))
        profile_phase(torch, passes)

    kernels = []
    for row in rows:
        name, counter, label, err, ms, plain, bms, bby, lib_ms = row[:9]
        launches = (row[9] if len(row) > 9 else
                    runs[COUNTER_RUN.get(counter, "round0")].get(counter, 0))
        kernels.append({
            "name": f"{name} ({label})", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": bby,
            "library_ms": lib_ms,
        })
    summary["smoke_s"] = time.perf_counter() - t_start
    print(f"whole run: {summary['smoke_s']:.1f} s", flush=True)
    print(json.dumps({"path": summary}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
