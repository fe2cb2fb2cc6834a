"""One run of one cell: set-up, the measured window, the check.

    python3 -m mvsbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's scene from the seed (``scene.py``), builds the
program's scene runner, runs the earlier passes of the schedule over every
view (the traffic's ``setup``), and warms each pass kind of the window once
on view 0.  The window then replays the traffic's pass kinds of its round,
view after view (``window``: pass indices of the round, in order for each
view), each pass from the state the set-up left: the runner's state of the
view is put back after every pass, so no pass feeds another and every
window holds the same mix.  A round's first pass (index 0) forgets the
view's cached edges and label maps first, as a scene run computes them in
that pass.  Passes start until ``--seconds`` have elapsed; the
window ends when the last one returns.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profile of the window's first
passes (``trace_passes``).  Either way, once the window is over and the
program's runner is freed, one pass of each kind, drawn from the seed among
those the window ran, is made again by the plain reference on the card from
the same inputs and draws, and compared (``check.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from . import cells as cells_mod
from . import check, measure
from .scene import make_scene

PROGRAM = "dvpmvs_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "dvpmvs")
WARM_ITERATION = 1_000_000       # the draws of the warm-up passes


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def num_rounds(width: int, height: int, max_base_size: int) -> int:
    """The pyramid's round count (``ComputeRoundNum``, main.cpp:248-264)."""
    size, rounds = max(width, height), 1
    while size > max_base_size:
        size //= 2
        rounds += 1
    return rounds


@dataclasses.dataclass
class Window:
    """What the end-to-end readers of ``metrics/`` read: the window's pass
    walls and length, and the set-up's seconds."""

    pass_s: List[float]
    window_s: float
    setup_s: float


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Plan:
    """The cell's schedule: the scene's size, the rounds, the set-up's
    passes and the window's pass kinds."""

    def __init__(self, cell: cells_mod.Cell):
        cfg, tr = cell.config, cell.traffic
        self.rounds = num_rounds(cfg["image_width"], cfg["image_height"],
                                 cfg["max_base_size"])
        self.round = int(tr["round"])
        div = 2 ** (self.rounds - 1 - self.round)
        self.height = round(cfg["image_height"] / div)
        self.width = round(cfg["image_width"] / div)
        self.views = list(range(int(cfg["views"])))
        self.setup = [tuple(x) for x in tr["setup"]]
        self.kinds = [int(p) for p in tr["window"]]
        self.trace_passes = max(int(tr["trace_passes"]), len(self.kinds))

    def scale(self, rnd: int) -> int:
        """The scale of round ``rnd`` against the scene's size."""
        return 2 ** (self.round - rnd)

    def window_pass(self, k: int):
        """(pass index, view, iteration) of the window's k-th pass."""
        nk = len(self.kinds)
        return (self.kinds[k % nk], self.views[(k // nk) % len(self.views)],
                len(self.setup) + k)


def sources_of(views: List[int]) -> Dict[int, List[int]]:
    """Every other view, in id order (the synthetic scene's pair list)."""
    return {v: [u for u in views if u != v] for v in views}


def base_settings(cfg: dict) -> dict:
    return dict(max_iterations=int(cfg["iterations"]),
                use_edge=bool(cfg["use_edge"]),
                use_label=bool(cfg["use_label"]),
                use_radius=bool(cfg["use_radius"]),
                cost_backend=str(cfg["cost_backend"]))


class System:
    """The program under test: its scene runner over the cell's scene."""

    def __init__(self, plan: Plan, cfg: dict, sc, draws, dev):
        from dvpmvs_torch.config import PMStatic, SceneConfig
        from dvpmvs_torch.geometry.camera import Camera
        from dvpmvs_torch.io.scene import Problem, Scene
        from dvpmvs_torch.sched.runner import SceneRunner

        self.plan = plan
        self.draws = draws
        self.setup_state = {}
        self.acc2 = None
        views = plan.views
        srcs = sources_of(views)
        self.problems = {v: Problem(index=v, ref_image_id=v,
                                    src_image_ids=srcs[v], dense_folder=None,
                                    result_folder=None) for v in views}
        scene = Scene(dense_folder=None, image_ids=views,
                      images={v: sc.images[v] for v in views}, colors={},
                      cameras={v: Camera.create(**sc.cameras[v])
                               for v in views},
                      problems=[self.problems[v] for v in views])
        self.base = PMStatic(**base_settings(cfg))
        self.runner = SceneRunner(
            scene, SceneConfig(max_base_size=int(cfg["max_base_size"]),
                               geometric_passes=int(cfg["geometric_passes"])),
            base_static=self.base, verbose=False, device=dev, draws=draws)

    def params(self, rnd: int, p: int):
        from dvpmvs_torch.config import round_pass_params
        return round_pass_params(rnd, self.plan.rounds, p, self.base, 0.0,
                                 1.0)

    def view_pass(self, rnd: int, p: int, v: int, iteration: int) -> None:
        static, dyn = self.params(rnd, p)
        self.runner.run_view_pass(self.problems[v], static, dyn,
                                  self.plan.scale(rnd),
                                  self.draws.at(iteration, v))

    def forget_priors(self, v: int, rnd: int) -> None:
        """Drop the view's cached edges and label maps at the round's scale,
        so the next pass computes them as the round's first pass does."""
        scale = self.plan.scale(rnd).bit_length() - 1
        for cache in ("edge_cache", "label_cache"):
            getattr(self.runner, cache, {}).pop((v, scale), None)


class Card:
    """The device a run uses: the card, or the CPU where a test drives the
    rest of a run without one."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.is_cuda = dev.type == "cuda"

    def sync(self) -> None:
        if self.is_cuda:
            self.torch.cuda.synchronize(self.dev)

    def peak_bytes(self) -> int:
        return (int(self.torch.cuda.max_memory_allocated(self.dev))
                if self.is_cuda else 0)

    def name(self) -> str:
        return (self.torch.cuda.get_device_name(self.dev) if self.is_cuda
                else "cpu")

    def free(self) -> None:
        if self.is_cuda:
            self.torch.cuda.empty_cache()


class Draws:
    """The benchmark's draw source (the reference's frozen copy of the
    program's Philox source): the same numbers for program and reference."""

    def __init__(self, seed: int, dev):
        from .reference.rng import Rooted, TorchDraws, fold_in

        self._src = TorchDraws(seed, device=dev)
        self._rooted, self._fold_in = Rooted, fold_in

    def at(self, iteration: int, view: int):
        f = self._fold_in
        return self._rooted(self._src, f(f((), iteration), view))


def reference_pass(plan: Plan, cfg: dict, sc, state: dict, rnd: int, p: int,
                   v: int, iteration: int, draws: Draws, dev):
    """The reference's state of view ``v`` after the pass, from the
    set-up's ``state`` of every view."""
    from .reference import config as rc
    from .reference.geometry.camera import Camera
    from .reference.view_pass import ReferenceRunner, ViewState

    base = rc.PMStatic(**base_settings(cfg))
    cams = {u: Camera.create(**sc.cameras[u]) for u in plan.views}
    st = {u: ViewState(s.depth, s.normal_world, s.weak, s.sel_views,
                       s.radius) for u, s in state.items()}
    runner = ReferenceRunner({u: sc.images[u] for u in plan.views}, cams,
                             sources_of(plan.views), st, base, dev)
    static, dyn = rc.round_pass_params(rnd, plan.rounds, p, base, 0.0, 1.0)
    return runner.view_pass(v, static, dyn, plan.scale(rnd),
                            draws.at(iteration, v))


def make_cell_scene(plan: Plan, cfg: dict, seed: int):
    return make_scene(num_views=len(plan.views), height=plan.height,
                      width=plan.width, seed=seed % 2 ** 63,
                      **cfg["scene"])


def set_up(plan: Plan, cfg: dict, sc, seed: int, card: Card
           ) -> System:
    """The program's runner with the set-up's passes run over every view
    and each window kind warmed once on view 0."""
    system = System(plan, cfg, sc, Draws(seed, card.dev), card.dev)
    for it, (rnd, p) in enumerate(plan.setup):
        for v in plan.views:
            system.view_pass(rnd, p, v, it)
    system.setup_state = dict(system.runner.state)
    v0 = plan.views[0]
    for p in plan.kinds:
        system.view_pass(plan.round, p, v0, WARM_ITERATION)
        system.acc2 = measure.acc2(system.runner.state[v0].depth,
                                   sc.gt_depth[v0])
        system.runner.state = dict(system.setup_state)
    card.sync()
    return system


def run_window(plan: Plan, system: System, seconds: float, n_max=None,
               on_pass=None):
    """The measured window: (pass walls, window seconds, the passes as
    (pass index, view, iteration, the view's state after it))."""
    walls, done = [], []
    runner = system.runner
    t0 = t1 = time.perf_counter()
    k = 0
    while (k < n_max if n_max is not None
           else (k == 0 or time.perf_counter() - t0 < seconds)):
        p, v, it = plan.window_pass(k)
        if p == 0:
            system.forget_priors(v, plan.round)
        a = time.perf_counter()
        if on_pass is None:
            system.view_pass(plan.round, p, v, it)
        else:
            on_pass(lambda: system.view_pass(plan.round, p, v, it))
        t1 = time.perf_counter()
        walls.append(t1 - a)
        done.append((p, v, it, runner.state[v]))
        runner.state[v] = system.setup_state[v]
        k += 1
    return walls, t1 - t0, done


def pick_checked(done, seed: int):
    """One pass of each kind, drawn from the seed among those the window
    ran."""
    rng = np.random.default_rng(seed % 2 ** 63 + 1)
    picked = []
    for p in sorted({d[0] for d in done}):
        of_kind = [d for d in done if d[0] == p]
        picked.append(of_kind[int(rng.integers(len(of_kind)))])
    return picked


KIND_NAMES = {0: "init", 1: "geom1", 2: "geom2", 3: "geom3"}


def traced_window(torch, plan: Plan, system: System, card: Card):
    """The window's first ``trace_passes`` passes under the profiler, with
    the benchmark's spans installed: (TraceRecord, passes)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import dvpmvs_torch
    from dvpmvs_torch.kernels import weak
    from dvpmvs_torch.sched import runner as runner_mod

    from . import trace

    tracer = trace.Tracer(torch, PROGRAM, card.sync)
    kernels = {fn: getattr(importlib.import_module(
        f"{PROGRAM}.kernels.{mod}"), fn)
        for mod, fn in trace.KERNEL_ENTRIES.items()}
    tracer.install(runner_mod.run_pass,
                   {fn: getattr(weak, fn) for fn in trace.WEAK_ENTRIES},
                   kernels)

    def one(fn):
        with record_function(trace.PREFIX + "runner/run_view_pass"):
            fn()

    try:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if card.is_cuda else [])
        with profile(activities=acts) as prof:
            walls, window_s, done = run_window(
                plan, system, 0.0, n_max=plan.trace_passes, on_pass=one)
            card.sync()
    finally:
        tracer.remove()
    tracer.finish_counts()
    rec = tracer.record(prof, trace.program_kernel_names(
        Path(dvpmvs_torch.__file__).parent))
    del prof
    return rec, done


def check_passes(plan: Plan, cfg: dict, sc, setup_state: dict, picked,
                 draws: Draws, dev):
    """Each picked pass made again by the reference and compared:
    {name: {"value", "limit"}} and the count of passes not correct."""
    checks, failed = {}, 0
    for p, v, it, got in picked:
        want = reference_pass(plan, cfg, sc, setup_state, plan.round, p, v,
                              it, draws, dev)
        nums = check.numbers(got, want)
        failed += not check.verdict(nums)
        for k, x in nums.items():
            checks[f"{KIND_NAMES.get(p, p)}.{k}"] = {
                "value": x, "limit": check.LIMITS[k]}
    return checks, failed


def run_cell(torch, cell: cells_mod.Cell, seed: int, seconds: float,
             trace_on: bool, card: Card, started: float) -> dict:
    """One run of ``cell``: its result line as a dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, and ``checks``
    last), after printing the checks on standard error."""
    cfg = cell.config
    plan = Plan(cell)
    if card.is_cuda:
        from dvpmvs_torch.kernels import _build
        _build.build_all()
    sc = make_cell_scene(plan, cfg, seed)
    system = set_up(plan, cfg, sc, seed, card)
    setup_s = time.perf_counter() - started

    if trace_on:
        rec, done = traced_window(torch, plan, system, card)
    else:
        walls, window_s, done = run_window(plan, system, seconds)
    card.sync()
    peak = card.peak_bytes()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"mvsbench: the run loaded {', '.join(bad)}")

    setup_state = system.setup_state
    acc2 = system.acc2
    picked = pick_checked(done, seed)
    attempted = len(done)
    del system, done
    gc.collect()
    card.free()

    device = {"platform": "gpu" if card.is_cuda else "cpu",
              "kind": card.name(), "count": cell.chips,
              "memory_peak_bytes": peak}
    metrics = {}
    extra = {}
    if trace_on:
        from . import trace
        device["busy_s"] = rec.busy_s
        device["window_s"] = rec.window_s
        for m in cell.per_layer:
            value = cells_mod.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = trace.breakdown(rec)
        pat = trace.program_kernel_pattern(rec.program_kernels)
        own = [op for op in rec.device if pat and pat.search(op.name)]
        inside = sum(any(s.startswith(trace.PREFIX + "kernels/")
                         for s in op.spans) for op in own)
        print(f"mvsbench: traced {rec.n_passes} passes, "
              f"{len(rec.device)} device operations, {len(own)} of them "
              f"the program's kernels, {inside} of those inside the cost "
              f"kernels' spans; launch times from {rec.launch_times}",
              file=sys.stderr)
    else:
        win = Window(walls, window_s, setup_s)
        extra["pass_s"] = walls
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": cells_mod.metric_reader(m["name"])(win),
                "unit": m["unit"]}

    checks, failed = check_passes(plan, cfg, sc, setup_state, picked,
                                  Draws(seed, card.dev), card.dev)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"mvsbench: the run loaded {', '.join(bad)}")
    card_text = card_line() if card.is_cuda else "cpu"
    print(f"mvsbench: {cell.name} seed {seed} on {card_text}: "
          f"{attempted} passes, set-up {setup_s:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return {"correct": failed == 0, "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": device,
            **extra, "acc2": acc2, "card": card_text, "checks": checks}


def main(argv=None, started: float = None) -> int:
    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(prog="python3 -m mvsbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells_mod.load_cell(Path.cwd(), args.workload)

    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.chips:
        print(f"mvsbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {n}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line = run_cell(torch, cell, args.seed, args.seconds, bool(args.trace),
                    Card(torch, dev), started)
    print(json.dumps(line), flush=True)
    return 0
