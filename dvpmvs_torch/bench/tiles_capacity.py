"""Peak device memory and wall of one APD REFINE_ITER at a real scene's
size, untiled and row-tiled over n ranks of one card.

    python -m dvpmvs_torch.bench.tiles_capacity [--height 2016]
        [--width 3024] [--views 10] [--ranks 1 2 4] [--out FILE]

3024 x 2016 is an ETH3D image (6048 x 4032) at scale 2, the last default
round of a scene; its passes run with APD, labels and edges.  The scene is
synthetic (``make_scene``, seed 0, with its textureless band); the pass is
round 1's APD REFINE_ITER (``round_pass_params(1, 2, 1)``: geometric
consistency, rotate_time 2, 3 iterations, the fused backend) with a label
map of 96-pixel blocks, an edge map of the reference's strong gradients,
the ground-truth source depths and a radius map; the state starts from the
ground truth with 5 % depth noise and a 10 % random weak share.  Rank
counts above 1 start that many ranks with ``dist.launch`` (gloo on the one
card, NCCL on separate cards where there are enough) and run
``make_tiled_pass``.  Each run prints its wall and every rank's
``torch.cuda.max_memory_allocated``; a run that fails prints its error and
the next run goes on.  The lines go to standard output and, with
``--out``, as JSON to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def make_inputs(H: int, W: int, V: int, path: str) -> None:
    """The pass's inputs, saved to ``path`` (CPU tensors)."""
    from ..config import PixelState, PMStatic, round_pass_params
    from ..geometry import stack_cameras
    from ..utils.synthetic import make_scene

    scene = make_scene(num_views=V + 1, height=H, width=W, seed=0,
                       weak_band=True)
    ref = scene.cameras[0]
    st, dyn = round_pass_params(
        1, 2, 1, PMStatic(num_src=V, cost_backend="fused"),
        float(ref.depth_min), float(ref.depth_max))
    rng = np.random.default_rng(0)
    depth = scene.gt_depth[0] * (1 + 0.05 * rng.standard_normal((H, W)))
    normal = scene.gt_normal[0] @ np.asarray(ref.R)
    img = np.asarray(scene.images[0], np.float32)
    gy, gx = np.gradient(img)
    label = ((np.arange(H)[:, None] // 96) * (W // 96 + 1)
             + np.arange(W)[None, :] // 96 + 1).astype(np.int32)
    kw = dict(
        init_plane_world=np.concatenate([normal, depth[..., None]],
                                        -1).astype(np.float32),
        init_sel_views=np.ones((H, W, V), bool),
        init_weak=np.where(rng.uniform(size=(H, W)) < 0.1, PixelState.WEAK,
                           PixelState.STRONG).astype(np.int8),
        src_depths=np.stack(scene.gt_depth[1:]).astype(np.float32),
        radius_map=np.full((H, W), 5.0, np.float32),
        edge=np.hypot(gx, gy) > 40.0, label=label)
    torch.save({"args": (img, np.asarray(scene.images[1:], np.float32), ref,
                         stack_cameras(scene.cameras[1:]), st, dyn),
                "kw": {k: torch.as_tensor(v) for k, v in kw.items()}}, path)


def run_one(mesh, path: str) -> dict:
    """One pass from the inputs at ``path``: untiled in this process
    (``mesh`` None) or as a rank of ``mesh``; its wall and peak memory."""
    from ..dist import make_tiled_pass
    from ..engine import run_pass
    from ..rng import TorchDraws

    saved = torch.load(path, weights_only=False)
    img, srcs, ref, src_cams, st, dyn = saved["args"]
    dev = torch.device("cuda") if mesh is None else mesh.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if mesh is None:
        out = run_pass(img, srcs, ref, src_cams, st, dyn, TorchDraws(0, dev),
                       device=dev, **saved["kw"])
    else:
        out = make_tiled_pass(st, mesh)(img, srcs, ref, src_cams, dyn,
                                        TorchDraws(0, dev), **saved["kw"])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return {"wall_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "depth_finite": bool(torch.isfinite(out.depth).all()),
            "depth_sum": float(out.depth.double().sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=2016)
    ap.add_argument("--width", type=int, default=3024)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from ..dist import launch

    results = []
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "inputs.pt")
        t0 = time.perf_counter()
        make_inputs(args.height, args.width, args.views, path)
        print(f"inputs {args.height}x{args.width}, V={args.views}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for n in args.ranks:
            rec = {"ranks": n, "height": args.height, "width": args.width}
            try:
                if n == 1:
                    rec["per_rank"] = [run_one(None, path)]
                else:
                    cards = torch.cuda.device_count()
                    devices, backend = (
                        ([f"cuda:{r}" for r in range(n)], "nccl")
                        if cards >= n else (["cuda:0"] * n, "gloo"))
                    rec["backend"] = backend
                    rec["per_rank"] = launch(
                        run_one, n, (path,),
                        workdir=os.path.join(work, str(n)),
                        devices=devices, backend=backend)
            except Exception as e:                  # reported, not hidden
                rec["error"] = f"{type(e).__name__}: {e}"[:2000]
            torch.cuda.empty_cache()
            print(json.dumps(rec), flush=True)
            results.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
