"""The "warp" cost backend's two passes beside the fused REFINE_ITER, on
the card, through the ``chip_smoke.py`` of a checkout.

    python3 dvpmvs_torch/bench/warp_passes.py [--root DIR] [--runs N]

Imports ``chip_smoke.py`` and ``dvpmvs_torch`` from DIR (default: the
checkout that holds this file), so that one call on one card can compare
two checkouts, e.g. a parent unpacked with ``git archive`` beside the
change: run this file with ``--root`` set to each in turn.  On chip_smoke's
bench scene (608x800, V=10, 3 iterations) it runs round 0's fused
FIRST_INIT on views 0-4 (the state and source depths the REFINE_ITER
passes start from), then times N runs each of

* FIRST_INIT (warp), view 0, from random planes;
* REFINE_ITER (warp, radius map, geom), view 0, from the fused FIRST_INIT;
* REFINE_ITER (fused, radius map, geom), view 0, from the same state;

and one more run of each under torch.profiler.  Prints, per pass, one JSON
line: the walls, their median, acc2, the launches of one run, and the
profiled wall, device busy time, idle share, device events and device time
of the port's kernels; then the card's name and power limit.  Needs a CUDA
device.

A development tool for comparing two checkouts on one card: nothing in the
package, the tests or ``chip_smoke.py`` calls it or relies on its output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("warp_passes: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dvpmvs_torch.config import PMStatic, round_pass_params
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.kernels import _build
    from dvpmvs_torch.rng import TorchDraws
    from dvpmvs_torch.utils.synthetic import make_scene

    card = cs.card_line()
    print(f"root {root}\n{card}", flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    scene = make_scene(num_views=5, height=cs.H, width=cs.W, seed=2)
    fused = PMStatic(num_src=cs.V, max_iterations=cs.ITERS,
                     cost_backend="fused")
    first, _, _ = cs.first_init_views(torch, dev, scene, fused, "fused ")
    reps, cam, edge = cs.problem(torch, scene, 0)
    src_cams = stack_cameras([scene.cameras[i] for i in reps])
    out0 = first[0][0]
    lim = (float(cam.depth_min), float(cam.depth_max))
    init = dict(init_plane_world=torch.cat(
        [out0.normal_world, out0.depth[..., None]], -1),
        init_sel_views=out0.sel_views, init_weak=out0.weak,
        src_depths=torch.stack([first[r][0].depth for r in reps]),
        radius_map=out0.radius)

    def pass_fn(backend, kind):
        base = PMStatic(num_src=cs.V, max_iterations=cs.ITERS,
                        cost_backend=backend)
        st, dyn = round_pass_params(0, 1, kind, base, *lim)
        kw = init if kind else {}
        seed = 100 if kind else 0
        return lambda: run_pass(scene.images[0], scene.images[reps], cam,
                                src_cams, st, dyn, TorchDraws(seed, dev),
                                edge=edge, device=dev, **kw)

    passes = [("FIRST_INIT (warp)", pass_fn("warp", 0)),
              ("REFINE_ITER (warp, radius map, geom)", pass_fn("warp", 1)),
              ("REFINE_ITER (fused, radius map, geom)", pass_fn("fused", 1))]
    kernels = ("ncc_fused_kernel", "sweep_kernel", "geom_kernel",
               "warp_ncc_kernel", "warp_kernel")
    for label, fn in passes:
        walls = []
        for _ in range(args.runs):
            out, dt, launches = cs.timed(torch, fn)
            walls.append(dt)
        a = cs.acc2(out.depth.cpu().numpy(), scene.gt_depth[0])
        spans, by_name, busy, wall = cs.device_profile(torch, fn)
        kernel_s = {k: 0.0 for k in kernels}
        for name, us in by_name.items():
            for k in kernels:
                if k in name:
                    kernel_s[k] += us * 1e-6
                    break
        row = {"pass": label, "walls_s": walls,
               "median_s": sorted(walls)[len(walls) // 2], "acc2": a,
               "launches": launches, "profiled_wall_s": wall,
               "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
               "device_events": len(spans), "kernel_device_s": kernel_s}
        print(json.dumps(row), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
