"""Rank functions for the port's multi-rank tests (tests/test_torch_dist*.py).

Each runs in a process that ``dvpmvs_torch.dist.launch`` spawned, as
``fn(mesh, *args)``, imports only the port (never JAX, whose threads live
in the test process) and returns picklable results: numpy arrays and
launch counts.
"""

import dataclasses
from pathlib import Path

import numpy as np


def _state(runner) -> dict:
    return {v: {f.name: np.asarray(getattr(st, f.name))
                for f in dataclasses.fields(st)}
            for v, st in runner.state.items()}


def scene_rank(mesh, folder, checkpoint_dir, config_kw, static_kw):
    """``SceneRunner(...).run(checkpoint_dir)`` on this rank (the batched
    schedule over the group): every view's state as this rank holds it."""
    from dvpmvs_torch.config import PMStatic, SceneConfig
    from dvpmvs_torch.io import load_scene
    from dvpmvs_torch.sched import SceneRunner

    runner = SceneRunner(load_scene(folder, max_src_views=2),
                         SceneConfig(**config_kw), PMStatic(**static_kw),
                         verbose=False, device=mesh.device, group=mesh.group)
    runner.run(checkpoint_dir=Path(checkpoint_dir))
    return {"state": _state(runner), "iteration": runner.iteration,
            "rank": mesh.rank, "size": mesh.size,
            "counters": runner.metrics.summary()["counters"]}


def multihost_rank(mesh, folder, checkpoint_dir, config_kw, static_kw):
    """Two-host ``MultiHostRunner`` over the group: state synced through
    ``checkpoint_dir``'s files, or (None) by the collective exchange.
    Returns every view's state and the views this host owns."""
    from dvpmvs_torch.config import PMStatic, SceneConfig
    from dvpmvs_torch.dist.multihost import MultiHostRunner
    from dvpmvs_torch.io import load_scene

    ck = Path(checkpoint_dir) if checkpoint_dir else None
    runner = MultiHostRunner(load_scene(folder, max_src_views=2),
                             SceneConfig(**config_kw), PMStatic(**static_kw),
                             checkpoint_dir=ck, group=mesh.group,
                             verbose=False, device=mesh.device)
    runner.run(checkpoint_dir=ck)
    return {"state": _state(runner),
            "owned": sorted(p.ref_image_id for p in runner.scene.problems),
            "needed": sorted({s for p in runner.scene.problems
                              for s in p.src_image_ids})}


def fusion_rank(mesh, inputs, variant, out_ply):
    """``run_fusion_sharded`` over the group."""
    from dvpmvs_torch.fusion import run_fusion_sharded

    return run_fusion_sharded(inputs, variant, out_ply=out_ply,
                              group=mesh.group, device=mesh.device)


def gather_rank(mesh):
    """``all_gather`` and ``exchange_src_depths`` of small tensors."""
    import torch

    from dvpmvs_torch.dist import all_gather, exchange_src_depths

    r = mesh.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    depths = torch.full((2, 2, 3), float(r)) + torch.arange(2.0)[:, None,
                                                                None]
    src_index = [[3 - 2 * r, 0], [2 - 2 * r, 1]]
    return {"gather": all_gather(x, mesh.group).numpy(),
            "bools": all_gather(x > 12, mesh.group).numpy(),
            "src": exchange_src_depths(depths, src_index,
                                       mesh.group).numpy()}


# ------------------------------------------------------ the row-tiled pass --

# (kind, PMStatic overrides, height): the cases of tests/test_torch_tiles.py
TILE_CASES = {
    "first/fused": ("first", dict(cost_backend="fused"), 32),
    "first/exact": ("first", dict(cost_backend="exact"), 32),
    "first/warp": ("first", dict(cost_backend="warp", strong_radius=2), 32),
    "iter/fused": ("iter", dict(cost_backend="fused", use_radius=False), 32),
    "iter/fused/radius": ("iter", dict(cost_backend="fused"), 32),
    "iter/warp": ("iter", dict(cost_backend="warp", strong_radius=2), 32),
    "init/apd": ("init", dict(cost_backend="fused"), 32),
    "apd/fused/labels": ("apd", dict(cost_backend="fused"), 32),
    "apd/warp": ("apd", dict(cost_backend="warp", strong_radius=2), 32),
    "apd/taps3": ("apd", dict(cost_backend="fused", anchor_taps=3), 32),
    "apd/exact_deformable": ("apd", dict(cost_backend="fused",
                                         exact_deformable=True), 32),
    "apd/overflow/debug": ("apd", dict(cost_backend="fused",
                                       weak_budget_frac=0.01,
                                       debug_dumps=True), 32),
    "apd/odd_rows": ("apd", dict(cost_backend="fused"), 30),
}
TILE_FIELDS = ("depth", "normal_world", "cost", "weak", "sel_views",
               "view_weights", "radius", "weak_overflow", "cost_line",
               "anchors_xy", "anchors_valid")


def tile_case(name, W=48, V=2):
    """The inputs of a tiled-pass case: (args, kwargs) of ``run_pass``
    (without device), from a seeded ``weak_band`` scene: FIRST_INIT; a
    round-0 REFINE_ITER (geometric consistency, a radius map); round 1's
    REFINE_INIT and APD REFINE_ITER with edges and labels."""
    from dvpmvs_torch.config import PixelState, PMStatic, round_pass_params
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.rng import TorchDraws
    from dvpmvs_torch.utils.synthetic import make_scene

    kind, over, H = TILE_CASES[name]
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=6,
                       weak_band=True)
    ref = scene.cameras[0]
    base = PMStatic(num_src=V, max_iterations=1, **over)
    rnd, pas = {"first": (0, 0), "iter": (0, 1), "init": (1, 0),
                "apd": (1, 1)}[kind]
    st, dyn = round_pass_params(rnd, 1 + rnd, pas, base,
                                float(ref.depth_min), float(ref.depth_max))
    if kind == "init":
        st = st.replace(use_detail=True)
    rng = np.random.default_rng(0)
    kw = {}
    if kind != "first":
        depth = scene.gt_depth[0] * (1 + 0.05 * rng.standard_normal((H, W)))
        normal = scene.gt_normal[0] @ np.asarray(ref.R)
        kw["init_plane_world"] = np.concatenate(
            [normal, depth[..., None]], -1).astype(np.float32)
        kw["init_sel_views"] = rng.uniform(size=(H, W, V)) < 0.8
        share = 0.9 if "overflow" in name else 0.4
        kw["init_weak"] = np.where(rng.uniform(size=(H, W)) < share,
                                   PixelState.WEAK,
                                   PixelState.STRONG).astype(np.int8)
        kw["src_depths"] = np.stack(scene.gt_depth[1:]).astype(np.float32)
        kw["radius_map"] = np.where(rng.uniform(size=(H, W)) < 0.5, 5.0,
                                    7.5).astype(np.float32)
    if kind in ("init", "apd"):
        kw["edge"] = rng.uniform(size=(H, W)) < 0.05
        kw["label"] = np.broadcast_to(np.arange(W)[None, :] // 12 + 1,
                                      (H, W)).astype(np.int32)
    args = (scene.images[0], scene.images[1:], ref,
            stack_cameras(scene.cameras[1:]), st, dyn,
            TorchDraws(3, device="cpu"))
    return args, kw


def _out_np(out) -> dict:
    return {f: (None if getattr(out, f) is None
                else np.asarray(getattr(out, f))) for f in TILE_FIELDS}


def tiles_rank(mesh, names):
    """Every case of ``names`` through ``make_tiled_pass`` over the group,
    and this rank's share of the untiled references (cases r, r + n, ...).
    """
    from dvpmvs_torch.dist import make_tiled_pass
    from dvpmvs_torch.engine import run_pass

    tiled, ref = {}, {}
    for i, name in enumerate(names):
        (img, srcs, rc, sc, st, dyn, draws), kw = tile_case(name)
        tiled[name] = _out_np(make_tiled_pass(st, mesh)(img, srcs, rc, sc,
                                                        dyn, draws, **kw))
        if i % mesh.size == mesh.rank:
            ref[name] = _out_np(run_pass(img, srcs, rc, sc, st, dyn, draws,
                                         device="cpu", **kw))
    return {"tiled": tiled, "ref": ref}


def mesh2_rank(mesh, n_views, n_tiles):
    """``make_mesh2`` over the world: this rank's places, and the ranks an
    all-gather over each of its two subgroups sees."""
    import torch

    from dvpmvs_torch.dist import all_gather, make_mesh2

    m = make_mesh2(n_views, n_tiles, device="cpu")
    r = torch.tensor([mesh.rank], dtype=torch.int64)
    return {"views": (m.views.rank, m.views.size),
            "tile": (m.tile.rank, m.tile.size),
            "views_ranks": all_gather(r, m.views.group).tolist(),
            "tile_ranks": all_gather(r, m.tile.group).tolist()}


def views_sharded_rank(mesh, B):
    """``run_views_sharded`` over the group on a batch of B FIRST_INIT
    problems (``views_batch``)."""
    from dvpmvs_torch.dist import run_views_sharded

    static, args = views_batch(B)
    return _out_np(run_views_sharded(static, mesh, *args))


def views_batch(B, H=24, W=32, V=2):
    """A problem batch of B FIRST_INIT passes of one seeded scene: (static,
    (ref_imgs, src_imgs, ref_cams, src_cams, dyns, draws))."""
    import torch

    from dvpmvs_torch.config import PMStatic, round_pass_params
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.rng import Rooted, TorchDraws, fold_in
    from dvpmvs_torch.utils.synthetic import make_scene

    scene = make_scene(num_views=B + V, height=H, width=W, seed=4)
    st, _ = round_pass_params(0, 1, 0, PMStatic(num_src=V, max_iterations=1,
                                                cost_backend="fused"),
                              0.0, 1.0)
    probs = [(b, [(b + 1 + j) % (B + V) for j in range(V)])
             for b in range(B)]
    cams = scene.cameras
    dyns = [round_pass_params(0, 1, 0, st, float(cams[b].depth_min),
                              float(cams[b].depth_max))[1]
            for b, _ in probs]
    draws = TorchDraws(5, device="cpu")
    return st, (torch.as_tensor(np.stack([scene.images[b] for b, _ in probs])),
                torch.as_tensor(np.stack([np.stack([scene.images[s]
                                                    for s in ss])
                                          for _, ss in probs])),
                [cams[b] for b, _ in probs],
                [stack_cameras([cams[s] for s in ss]) for _, ss in probs],
                dyns,
                [Rooted(draws, fold_in((), b)) for b, _ in probs])
