"""The weak battery's "band" scene through both packages with the same
draws: a diagnosis of the gap between the port's region acc2 with its own
draws and the JAX package's (not a test; run it by hand).

    python -m tests.torch_band_gap [--jax] [--seeds N] [--scene band]

The schedule is tests/test_weak_battery.py's (FIRST_INIT, the textureless
region injected as WEAK, REFINE_INIT and REFINE_ITER with use_APD, two
iterations each, 64x96, V=3), with the battery's keys PRNGKey(0),
fold_in(key, 1) and fold_in(key, 2).  The port runs it with the jax-backed
draw source on the "exact" and "fused" backends, each with its own math and
with JAX's (``jax_math``); ``--jax`` also runs JAX's schedule (jitted at
XLA's default level, as the battery does: ~10 min on the CPU) and prints,
pass by pass, the share of pixels whose depths agree within 1e-4 and 1 %.
``--seeds N`` runs the port's production draw source (``TorchDraws``, seeds
0 .. N-1, as tests/test_torch_battery_weak.py draws) on the "fused"
backend: the spread of the region acc2 over draws.  Each result is one
JSON line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  (JAX on the CPU, as in the suite)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from test_torch_support import (JaxDraws, jax_math, t_camera,  # noqa: E402
                                t_cameras)
from test_weak_battery import (NV, SCENES, V, _pass_fn,  # noqa: E402
                               _region_mask)

from dvpmvs import config as j_config  # noqa: E402
from dvpmvs.geometry import stack_cameras  # noqa: E402
from dvpmvs.utils.synthetic import make_scene  # noqa: E402

from dvpmvs_torch.config import (PMDynamic, PMStatic,  # noqa: E402
                                 PixelState, RunState)
from dvpmvs_torch.engine import run_pass  # noqa: E402
from dvpmvs_torch.rng import TorchDraws  # noqa: E402


def region_acc(depth, gt, region):
    rel = np.abs(depth - gt) / np.maximum(gt, 1e-6)
    return float(((rel < 0.02) & (depth > 0) & region).sum()
                 / max(int(region.sum()), 1))


def inject(weak, region, xp):
    w = xp.where(region, int(PixelState.WEAK), weak)
    return xp.where((w == int(PixelState.WEAK)) & ~region,
                    int(PixelState.STRONG), w)


def port_schedule(scene, region, backend, seed=None):
    """The battery's schedule in the port, on the CPU, with JAX's keys (or,
    with ``seed``, TorchDraws(seed), (seed + 1), (seed + 2))."""
    ref, src = t_camera(scene.cameras[0]), t_cameras(scene.cameras[1:])
    ri, si = scene.images[0], scene.images[1:]
    dyn = PMDynamic.create(depth_min=float(ref.depth_min),
                           depth_max=float(ref.depth_max))
    base = dict(num_src=V, cost_backend=backend, rotate_time=2,
                use_edge=False, use_label=False, max_iterations=2)
    key = jax.random.PRNGKey(0)
    if seed is None:
        draws = [JaxDraws(key), JaxDraws(jax.random.fold_in(key, 1)),
                 JaxDraws(jax.random.fold_in(key, 2))]
    else:
        draws = [TorchDraws(seed + i, device="cpu") for i in range(3)]
    first = run_pass(ri, si, ref, src,
                     PMStatic(state=RunState.FIRST_INIT, **base), dyn,
                     draws[0], device="cpu")
    weak = inject(first.weak, torch.as_tensor(region), torch).to(torch.int8)

    def init(o):
        return dict(init_plane_world=torch.cat(
            [o.normal_world, o.depth[..., None]], -1),
            init_sel_views=o.sel_views, init_weak=weak)

    mid = run_pass(ri, si, ref, src,
                   PMStatic(state=RunState.REFINE_INIT, use_APD=True, **base),
                   dyn, draws[1], device="cpu",
                   **init(first))
    out = run_pass(ri, si, ref, src,
                   PMStatic(state=RunState.REFINE_ITER, use_APD=True,
                            geom_consistency=True, **base),
                   dyn, draws[2], device="cpu",
                   src_depths=scene.gt_depth[1:], **init(mid))
    return [np.asarray(o.depth) for o in (first, mid, out)]


def jax_schedule(scene, region):
    """tests/test_weak_battery.py::_full_schedule, default mode, keeping the
    depth of every pass."""
    ref_cam = scene.cameras[0]
    src_cams = stack_cameras(scene.cameras[1:])
    ri, si = jnp.asarray(scene.images[0]), jnp.asarray(scene.images[1:])
    dyn = j_config.PMDynamic.create(depth_min=float(ref_cam.depth_min),
                                    depth_max=float(ref_cam.depth_max))
    key = jax.random.PRNGKey(0)
    base = dict(num_src=V, cost_backend="exact", rotate_time=2,
                use_edge=False, use_label=False, max_iterations=2)
    S = j_config.PMStatic
    R = j_config.RunState
    first = _pass_fn(S(state=R.FIRST_INIT, **base))(ri, si, ref_cam, src_cams,
                                                    dyn=dyn, key=key)
    weak = inject(jnp.asarray(first.weak), jnp.asarray(region), jnp
                  ).astype(jnp.int8)

    def init(o):
        return dict(init_plane_world=jnp.concatenate(
            [o.normal_world, o.depth[..., None]], -1),
            init_sel_views=o.sel_views, init_weak=weak)

    mid = _pass_fn(S(state=R.REFINE_INIT, use_APD=True, **base))(
        ri, si, ref_cam, src_cams, dyn=dyn, key=jax.random.fold_in(key, 1),
        **init(first))
    out = _pass_fn(S(state=R.REFINE_ITER, use_APD=True,
                     geom_consistency=True, **base))(
        ri, si, ref_cam, src_cams, dyn=dyn, key=jax.random.fold_in(key, 2),
        src_depths=jnp.asarray(scene.gt_depth[1:]), **init(mid))
    return [np.asarray(o.depth) for o in (first, mid, out)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="band")
    p.add_argument("--jax", action="store_true")
    p.add_argument("--seeds", type=int, default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    spec = SCENES[args.scene]
    dims, kw = spec["dims"], spec["kw"]
    region = _region_mask(dims, kw)
    scene = make_scene(num_views=NV, height=dims[0], width=dims[1], **kw)
    gt = scene.gt_depth[0]
    if args.seeds:
        accs = []
        for seed in range(0, 3 * args.seeds, 3):
            d = port_schedule(scene, region, "fused", seed=seed)
            accs.append(region_acc(d[2], gt, region))
        print(json.dumps({"run": "port/fused/TorchDraws", "seeds":
                          list(range(0, 3 * args.seeds, 3)), "acc": accs,
                          "mean": float(np.mean(accs)),
                          "min": min(accs), "max": max(accs)}), flush=True)
        return
    runs = {}
    for backend in ("exact", "fused"):
        for math in ("port", "jax"):
            t0 = time.time()
            if math == "jax":
                with jax_math():
                    d = port_schedule(scene, region, backend)
            else:
                d = port_schedule(scene, region, backend)
            runs[f"port/{backend}/{math}-math"] = d
            print(json.dumps({"run": f"port/{backend}/{math}-math",
                              "acc0": region_acc(d[0], gt, region),
                              "acc_mid": region_acc(d[1], gt, region),
                              "acc": region_acc(d[2], gt, region),
                              "s": round(time.time() - t0, 1)}), flush=True)
    if args.jax:
        t0 = time.time()
        want = jax_schedule(scene, region)
        print(json.dumps({"run": "jax/exact",
                          "acc0": region_acc(want[0], gt, region),
                          "acc_mid": region_acc(want[1], gt, region),
                          "acc": region_acc(want[2], gt, region),
                          "s": round(time.time() - t0, 1)}), flush=True)
        for name, got in runs.items():
            agree = []
            for a, b in zip(want, got):
                rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-6)
                agree.append({"1e-4": float((rel <= 1e-4).mean()),
                              "1pct": float((rel <= 1e-2).mean()),
                              "region_1pct": float((rel <= 1e-2)[region]
                                                   .mean())})
            print(json.dumps({"agreement": name, "first_mid_last": agree}),
                  flush=True)


if __name__ == "__main__":
    main()
