"""Command-line entry point of the port (counterpart of
``dvpmvs/cli/run.py``'s ``scene`` command):

  python -m dvpmvs_torch.cli.run scene <dense_folder> [options]

runs the schedule on one scene folder (MVSNet layout) and fuses the views
into ``<output>/APD.ply``, on the card unless ``--device cpu`` is given.
The flags are the JAX command's; ``--backend`` takes the port's names
(``fused``, the counterpart of JAX's ``pallas``, which it also accepts,
``exact`` and ``warp``).  ``--mono-prior``, ``--mesh-views`` and
``--mesh-tiles`` above 1, ``--show-medium-result`` and ``--debug-dumps``
raise: they are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _cmd_scene(args) -> int:
    from ..config import PMStatic, SceneConfig
    from ..fusion import run_fusion
    from ..io import load_scene
    from ..sched import SceneRunner

    if args.mono_prior:
        raise NotImplementedError("--mono-prior is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 4)")
    scene = load_scene(args.dense_folder, max_src_views=args.max_src_views,
                       load_colors=True)
    out_dir = Path(args.output or (Path(args.dense_folder) / "APD"))
    cfg = SceneConfig(
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
    runner = SceneRunner(scene, cfg, base_static=base, device=args.device)
    out_dir.mkdir(parents=True, exist_ok=True)
    runner.run(checkpoint_dir=out_dir if (args.checkpoint or args.resume)
               else None,
               resume=args.resume, profile_dir=args.profile_dir)
    with runner.metrics.timed("fusion"):
        pts, _ = run_fusion(runner.fusion_inputs(), variant=args.fusion,
                            out_ply=str(out_dir / "APD.ply"),
                            device=runner.device)
    if args.metrics:
        runner.metrics.dump(out_dir / "metrics.json")
    print(f"fused {len(pts)} points -> {out_dir / 'APD.ply'}")
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
                    help="devices along the view axis (not ported above 1)")
    ps.add_argument("--mesh-tiles", type=int, default=1,
                    help="devices along the image-row axis (not ported "
                         "above 1)")
    ps.add_argument("--full-res-round", action="store_true",
                    help="add the full-resolution round the reference "
                         "schedule stops before (main.cpp:450)")
    ps.add_argument("--mono-prior", action="store_true",
                    help="not ported yet")
    ps.add_argument("--checkpoint", action="store_true",
                    help="persist per-pass state (reference .dmb/.bin files)")
    ps.add_argument("--resume", action="store_true",
                    help="resume a checkpointed run from its progress cursor")
    ps.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace here")
    ps.add_argument("--show-medium-result", action="store_true",
                    help="not ported yet")
    ps.add_argument("--metrics", action="store_true",
                    help="dump per-pass and fusion timings to "
                         "<output>/metrics.json")
    ps.add_argument("--debug-dumps", action="store_true",
                    help="not ported yet")
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=_cmd_scene)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
