#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvpmvs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels (csrc/*.cu, one nvcc per source, in
   parallel) into build/dvpmvs_torch/;
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it (608x800, V=10), and times
   both with CUDA events;
4. path phase: runs the main path of pyramid round 0 through the port's
   entry point run_pass with the "fused" backend: FIRST_INIT on views 0-4 of
   a synthetic 608x800 scene (10 replicated source views, Canny edges,
   3 iterations), then REFINE_ITER on view 0 with the radius map of its
   FIRST_INIT output (as the scene runner passes it) and without (as the
   JAX bench does); checks depth accuracy against the ground truth and that
   every kernel was launched;
5. with ``--profile`` only: runs each pass once more under torch.profiler
   and prints the device's busy time and the device time by kernel;
6. prints one JSON line with the kernels' numbers, the card line, and as
   the last line {"ok": true, "device": {...}}.

Any failure raises, so the script exits non-zero before the last line.  It
needs a CUDA device and the repository's dvpmvs_torch package beside it.
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
K3_OPS_PER_VIEW = 110        # project, lookup, back-project, re-project

REPLACES = {
    "ncc_fused": "dvpmvs/kernels/ncc_fused.py:864",
    "sweep": "dvpmvs/kernels/sweep_pallas.py:286",
    "geom": "dvpmvs/kernels/geom_pallas.py:208",
}
SOURCES = {
    "ncc_fused": "dvpmvs_torch/csrc/ncc_fused.cu",
    "sweep": "dvpmvs_torch/csrc/sweep.cu",
    "geom": "dvpmvs_torch/csrc/geom.cu",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over reps launches (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        rows.append(("ncc_fused", label, err, ms, plain, *bound_ms(ops,
                                                                   nbytes)))

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
        rows.append(("sweep", label, err, ms, plain, *bound_ms(ops,
                                                               nbytes)))

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
        ops = K * H * W * V * K3_OPS_PER_VIEW
        nbytes = 4 * (K * H * W + V * H * W
                      + (V * H * W + K * H * W if fold else K * H * W * V))
        rows.append(("geom", label, err, ms, plain, *bound_ms(ops, nbytes)))
    return rows


def acc2(depth, gt) -> float:
    import numpy as np
    d = depth[MARGIN:-MARGIN, MARGIN:-MARGIN]
    g = gt[MARGIN:-MARGIN, MARGIN:-MARGIN]
    rel = np.abs(d - g) / np.maximum(g, 1e-6)
    return float(((rel < 0.02) & (d > 0)).mean())


def path_phase(torch, dev, scene):
    """FIRST_INIT on views 0-4, then REFINE_ITER on view 0 with and without
    the radius map, through run_pass with the fused backend."""
    import numpy as np
    from dvpmvs_torch.config import PMStatic, round_pass_params
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.priors.edges import edge_segment
    from dvpmvs_torch.rng import TorchDraws

    base = PMStatic(num_src=V, max_iterations=ITERS, cost_backend="fused")
    nv = len(scene.cameras)

    def problem(v):
        others = [i for i in range(nv) if i != v]
        reps = [others[j % len(others)] for j in range(V)]
        cam = scene.cameras[v]
        edge = torch.as_tensor(edge_segment(0, scene.images[v]) > 0)
        return reps, cam, edge

    def timed(fn):
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
        return out, dt, launches

    per_pass = {}
    passes = {}
    _build.reset_launches()
    first = {}
    for v in range(nv):
        reps, cam, edge = problem(v)
        st, dyn = round_pass_params(0, 1, 0, base, float(cam.depth_min),
                                    float(cam.depth_max))
        fn = (lambda v=v, reps=reps, cam=cam, edge=edge, st=st, dyn=dyn:
              run_pass(scene.images[v], scene.images[reps], cam,
                       stack_cameras([scene.cameras[i] for i in reps]), st,
                       dyn, TorchDraws(v, dev), edge=edge, device=dev))
        out, dt, launches = timed(fn)
        a = acc2(out.depth.cpu().numpy(), scene.gt_depth[v])
        print(f"  FIRST_INIT view {v}: {dt:.3f} s, acc2 {a:.4f}, "
              f"launches {launches}", flush=True)
        if not torch.isfinite(out.depth).all() or \
                tuple(out.depth.shape) != (H, W):
            raise AssertionError(f"FIRST_INIT view {v}: bad depth map")
        first[v] = (out, dt, a)
        if v == 0:
            per_pass["FIRST_INIT"] = launches
            passes["FIRST_INIT"] = fn
    out0, first_dt, first_acc = first[0]
    if first_acc < ACC2_FLOOR:
        raise AssertionError(f"FIRST_INIT acc2 {first_acc:.4f} < "
                             f"{ACC2_FLOOR}")

    reps, cam, edge = problem(0)
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
        out, dt, launches = timed(fn)
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
    totals = dict(_build.LAUNCHES)
    for name, n in totals.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
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
    return totals, summary, passes


def profile_phase(torch, passes):
    """One more run of each pass under torch.profiler: the device's busy
    time (the union of its kernel and copy intervals) against the pass's
    wall time, and the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ours = {"ncc_fused_kernel": "ncc_fused", "sweep_kernel": "sweep",
            "geom_kernel": "geom"}
    result = {}
    for label, fn in passes.items():
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
        kernel_us = {k: 0.0 for k in ours.values()}
        for name, us in by_name.items():
            for tag, k in ours.items():
                if tag in name:
                    kernel_us[k] += us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        row = {"wall_s": wall, "device_busy_s": busy * 1e-6,
               "device_idle_share": 1.0 - busy * 1e-6 / wall,
               "device_events": len(spans),
               "kernel_s": {k: us * 1e-6 for k, us in kernel_us.items()},
               "other_device_s": (sum(by_name.values())
                                  - sum(kernel_us.values())) * 1e-6,
               "top": [[n[:60], us * 1e-6] for n, us in top]}
        print(f"  {label}: {json.dumps(row)}", flush=True)
        result[label] = row
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.utils.synthetic import make_scene

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    dev = torch.device("cuda")

    scene = make_scene(num_views=5, height=H, width=W, seed=2)
    reps0 = [[1, 2, 3, 4][j % 4] for j in range(V)]
    print("kernel phase (kernel vs plain on the card):", flush=True)
    rows = kernel_phase(torch, dev, scene, reps0)
    print("path phase (fused backend, 608x800, V=10):", flush=True)
    totals, summary, passes = path_phase(torch, dev, scene)
    if "--profile" in sys.argv[1:]:
        print("profile phase (torch.profiler, one run of each pass):",
              flush=True)
        profile_phase(torch, passes)

    kernels = []
    for name, label, err, ms, plain, bms, bby in rows:
        kernels.append({
            "name": f"{name} ({label})", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": totals[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": bby,
            "library_ms": None,
        })
    print(json.dumps({"path": summary}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
