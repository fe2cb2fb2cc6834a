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
