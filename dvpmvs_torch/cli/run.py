"""Command-line entry points of the port (counterparts of
``dvpmvs/cli/run.py``'s commands):

  python -m dvpmvs_torch.cli.run scene <dense_folder> [options]
  python -m dvpmvs_torch.cli.run prior <dense_folder> [options]
  python -m dvpmvs_torch.cli.run convert <colmap_dense> <out>
  python -m dvpmvs_torch.cli.run synth <out_folder>

``scene`` runs the schedule on one scene folder (MVSNet layout) and fuses
the views into ``<output>/APD.ply``; ``prior`` writes the
Depth-Anything-V2 maps ``dep/%08d.dmb`` that ``scene --mono-prior`` reads
with the folder's ``sfm/`` points.  Both run on the card unless ``--device
cpu`` is given.  ``convert`` turns a COLMAP model into that layout (images
through PIL) and ``synth`` writes a synthetic scene folder; neither uses a
device.  The flags are the JAX commands'; ``--backend`` takes the port's
names (``fused``, the counterpart of JAX's ``pallas``, which it also
accepts, ``exact`` and ``warp``).  ``scene --mesh-views N`` runs the
batched schedule over n = min(N, cards) ranks, one process per card joined
by NCCL (with ``--device cpu``, N gloo ranks on the CPU); for n = 1 it runs
in this process.  ``--mesh-tiles`` above 1 raises: the row-tiled pass is
not ported yet (ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _cmd_scene(args) -> int:
    """The scene command: in this process, or over ``--mesh-views`` ranks
    (one process each; rank 0 writes the checkpoint, the metrics and the
    PLY)."""
    import tempfile

    import torch

    if args.mesh_tiles > 1:
        raise NotImplementedError(
            "the row-tiled pass (--mesh-tiles > 1) is not ported yet "
            "(ROADMAP.md, Queue 1 item 7)")
    on_cpu = (args.device is not None
              and torch.device(args.device).type == "cpu")
    n = 1
    if args.mesh_views > 1:
        n = (args.mesh_views if on_cpu
             else min(args.mesh_views, torch.cuda.device_count()))
        print(f"[dvpmvs_torch] --mesh-views {args.mesh_views}: {n} rank(s)"
              + ("" if on_cpu else f" ({torch.cuda.device_count()} card(s))")
              + (", in this process" if n <= 1 else ""), flush=True)
    if n <= 1:
        return _scene(args, group=None, device=args.device)
    from ..dist import launch

    devices = ["cpu"] * n if on_cpu else [f"cuda:{r}" for r in range(n)]
    threads = max(1, torch.get_num_threads() // n) if on_cpu else None
    with tempfile.TemporaryDirectory() as work:
        launch(_scene_rank, n, args=(vars(args),), workdir=work,
               devices=devices, threads=threads)
    return 0


def _scene_rank(mesh, argd) -> int:
    return _scene(argparse.Namespace(**argd), group=mesh.group,
                  device=mesh.device)


def _scene(args, group, device) -> int:
    from ..config import PMStatic, SceneConfig
    from ..fusion import run_fusion
    from ..io import load_scene
    from ..sched import SceneRunner

    scene = load_scene(args.dense_folder, max_src_views=args.max_src_views,
                       load_colors=True)
    out_dir = Path(args.output or (Path(args.dense_folder) / "APD"))
    cfg = SceneConfig(
        output_folder=str(out_dir),
        max_base_size=args.max_base_size,
        geometric_passes=args.geometric_passes,
        show_medium_result=args.show_medium_result,
        full_res_round=args.full_res_round,
        mesh_views=args.mesh_views,
        mesh_tiles=args.mesh_tiles,
        seed=args.seed,
    )
    base = PMStatic(
        max_iterations=args.iterations,
        use_edge=not args.no_edge,
        use_label=not args.no_label,
        use_radius=not args.no_radius,
        cost_backend="fused" if args.backend == "pallas" else args.backend,
        debug_dumps=args.debug_dumps,
    )
    mono_planes = _mono_planes(scene, args.dense_folder) if args.mono_prior \
        else {}
    runner = SceneRunner(scene, cfg, base_static=base,
                         mono_planes=mono_planes, device=device, group=group)
    out_dir.mkdir(parents=True, exist_ok=True)
    runner.run(checkpoint_dir=out_dir if (args.checkpoint or args.resume)
               else None,
               resume=args.resume, profile_dir=args.profile_dir)
    if runner.rank == 0:
        with runner.metrics.timed("fusion"):
            pts, _ = run_fusion(runner.fusion_inputs(), variant=args.fusion,
                                out_ply=str(out_dir / "APD.ply"),
                                device=runner.device)
        if args.metrics:
            runner.metrics.dump(out_dir / "metrics.json")
        print(f"fused {len(pts)} points -> {out_dir / 'APD.ply'}")
    runner.barrier()
    return 0


def _mono_planes(scene, dense_folder) -> dict:
    """FIRST_INIT planes of every view with both ``dep/%08d.dmb`` and
    ``sfm/%08d.txt`` in the folder, at the image size."""
    from ..io.dmb import read_dmb
    from ..priors.mono import mono_prior_planes, read_sfm_txt

    dense = Path(dense_folder)
    planes = {}
    for p in scene.problems:
        vid = p.ref_image_id
        dep_path = dense / "dep" / f"{vid:08d}.dmb"
        sfm_path = dense / "sfm" / f"{vid:08d}.txt"
        if dep_path.exists() and sfm_path.exists():
            xy, xyz, _ = read_sfm_txt(sfm_path)
            planes[vid] = mono_prior_planes(
                read_dmb(dep_path), xy, xyz, scene.cameras[vid],
                target_hw=scene.images[vid].shape)
    return planes


def _cmd_prior(args) -> int:
    """Write ``dep/%08d.dmb`` monocular-depth maps for a scene with
    Depth-Anything-V2, one view at a time on the device: the maps the
    reference expects precomputed on disk (APD.cpp:1219-1223)."""
    import numpy as np
    import torch

    from ..io import load_scene
    from ..io.dmb import write_depth_dmb
    from ..priors.depth_anything import (DAConfig, infer_relative_depth,
                                         init_params)

    scene = load_scene(args.dense_folder, max_src_views=1)
    if args.checkpoint:
        from ..priors.convert import load_checkpoint

        model = load_checkpoint(args.checkpoint, device=args.device)
    else:
        print("[dvpmvs_torch] WARNING: no --checkpoint given; using randomly "
              "initialized DA-V2 weights (shape/pipeline testing only)")
        cfg = DAConfig.tiny_test() if args.tiny else DAConfig.vits()
        model = init_params(cfg, torch.Generator().manual_seed(args.seed),
                            device=args.device)
    model.eval()
    out_dir = Path(args.dense_folder) / "dep"
    out_dir.mkdir(parents=True, exist_ok=True)
    for vid in scene.image_ids:
        dep = infer_relative_depth(model, np.asarray(scene.images[vid],
                                                     np.float32))
        write_depth_dmb(out_dir / f"{vid:08d}.dmb", dep)
        print(f"[dvpmvs_torch] dep/{vid:08d}.dmb written")
    return 0


def _cmd_convert(args) -> int:
    from ..io.colmap import convert_colmap

    convert_colmap(args.dense_folder, args.save_folder,
                   model_subdir=args.model_subdir,
                   scale_factor=args.scale_factor, max_d=args.max_d)
    print(f"converted {args.dense_folder} -> {args.save_folder}")
    return 0


def _cmd_synth(args) -> int:
    from ..utils.synthetic import make_scene, write_scene_dir

    scene = make_scene(num_views=args.views, height=args.height,
                       width=args.width, seed=args.seed)
    write_scene_dir(scene, args.out_folder)
    print(f"wrote synthetic scene -> {args.out_folder}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dvpmvs_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("scene", help="run PatchMatch MVS on a scene")
    ps.add_argument("dense_folder")
    ps.add_argument("--output", default=None)
    ps.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    ps.add_argument("--fusion", default="eth3d",
                    choices=["eth3d", "tat_intermediate", "tat_advanced"])
    ps.add_argument("--iterations", type=int, default=3)
    ps.add_argument("--geometric-passes", type=int, default=3)
    ps.add_argument("--max-base-size", type=int, default=800)
    ps.add_argument("--max-src-views", type=int, default=20)
    ps.add_argument("--backend", default="fused",
                    choices=["fused", "pallas", "exact", "warp"])
    ps.add_argument("--no-edge", action="store_true")
    ps.add_argument("--no-label", action="store_true")
    ps.add_argument("--no-radius", action="store_true",
                    help="disable the adaptive per-pixel NCC radius")
    ps.add_argument("--mesh-views", type=int, default=1,
                    help="devices along the view axis: above 1, the batched "
                         "schedule over min(N, cards) ranks, one process "
                         "each (NCCL; with --device cpu, N gloo ranks)")
    ps.add_argument("--mesh-tiles", type=int, default=1,
                    help="devices along the image-row axis (not ported "
                         "above 1: ROADMAP.md, Queue 1 item 7)")
    ps.add_argument("--full-res-round", action="store_true",
                    help="add the full-resolution round the reference "
                         "schedule stops before (main.cpp:450)")
    ps.add_argument("--mono-prior", action="store_true",
                    help="start FIRST_INIT from the dep/ maps aligned to the "
                         "sfm/ points")
    ps.add_argument("--checkpoint", action="store_true",
                    help="persist per-pass state (reference .dmb/.bin files)")
    ps.add_argument("--resume", action="store_true",
                    help="resume a checkpointed run from its progress cursor")
    ps.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace here")
    ps.add_argument("--show-medium-result", action="store_true",
                    help="write per-pass depth/normal/weak jpgs "
                         "(main.cpp:396-403; needs PIL)")
    ps.add_argument("--metrics", action="store_true",
                    help="dump per-pass and fusion timings to "
                         "<output>/metrics.json")
    ps.add_argument("--debug-dumps", action="store_true",
                    help="write per-pass sweep cost curves and anchor lists "
                         "(reference DEBUG_COST_LINE / DEBUG_NEIGHBOUR "
                         "layouts) to each view's result folder")
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=_cmd_scene)

    pp = sub.add_parser("prior", help="run DA-V2 -> dep/%%08d.dmb maps")
    pp.add_argument("dense_folder")
    pp.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    pp.add_argument("--checkpoint", default=None,
                    help="released DA-V2 .pth (or .npz) to load and run")
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--tiny", action="store_true",
                    help="tiny random model (pipeline tests)")
    pp.set_defaults(fn=_cmd_prior)

    pc = sub.add_parser("convert", help="COLMAP model -> MVSNet layout")
    pc.add_argument("dense_folder")
    pc.add_argument("save_folder")
    pc.add_argument("--model-subdir", default="sparse")
    pc.add_argument("--scale-factor", type=int, default=1)
    pc.add_argument("--max-d", type=int, default=192)
    pc.set_defaults(fn=_cmd_convert)

    py = sub.add_parser("synth", help="write a synthetic demo scene")
    py.add_argument("out_folder")
    py.add_argument("--views", type=int, default=5)
    py.add_argument("--height", type=int, default=192)
    py.add_argument("--width", type=int, default=256)
    py.add_argument("--seed", type=int, default=0)
    py.set_defaults(fn=_cmd_synth)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
