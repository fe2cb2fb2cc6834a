"""The view pass: one call of ``SceneRunner.run_view_pass``, the stage of
every traffic mix that names none.

Set-up makes the cell's scene from the seed (``scene.py``), builds the
program's scene runner, runs the earlier passes of the schedule over every
view (the traffic's ``setup``), and warms each pass kind of the window once
on view 0.  The window then replays the traffic's pass kinds of its round,
view after view (``window``: pass indices of the round, in order for each
view), each pass from the state the set-up left: the runner's state of the
view is put back after every pass, so no pass feeds another and every
window holds the same mix.  A round's first pass (index 0) forgets the
view's cached edges and label maps first, as a scene run computes them in
that pass.

A traced pass lies in the benchmark's span ``runner/run_view_pass``, with
the spans of ``trace.py`` installed, and is bounded in the program's record
by its ``runner/view_pass``.  One pass of each kind, drawn from the seed
among those the window ran, is made again by the plain reference on the
card from the same inputs and draws, and compared (``check.py``).
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List

from .. import cells as cells_mod
from .. import check as check_mod
from .. import measure, program_spans, trace
from ..scene import make_scene
from . import Pass

PROGRAM = "dvpmvs_torch"
WARM_ITERATION = 1_000_000       # the draws of the warm-up passes
OUTER_SPAN = trace.OUTER_SPAN                  # runner/run_view_pass
PROGRAM_SPAN = program_spans.VIEW_PASS         # runner/view_pass
WORK = (trace._work, trace._k4_counts)
KIND_NAMES = {0: "init", 1: "geom1", 2: "geom2", 3: "geom3"}


def num_rounds(width: int, height: int, max_base_size: int) -> int:
    """The pyramid's round count (``ComputeRoundNum``, main.cpp:248-264)."""
    size, rounds = max(width, height), 1
    while size > max_base_size:
        size //= 2
        rounds += 1
    return rounds


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

    def window_pass(self, k: int) -> Pass:
        """The window's k-th pass; ``finish`` puts the view's set-up state
        back and gives (pass index, view, iteration, the view's state after
        the pass)."""
        plan = self.plan
        p, v, it = plan.window_pass(k)
        if p == 0:
            self.forget_priors(v, plan.round)

        def finish():
            got = self.runner.state[v]
            self.runner.state[v] = self.setup_state[v]
            return p, v, it, got
        return Pass(p, lambda: self.view_pass(plan.round, p, v, it), finish)

    @property
    def kept(self) -> dict:
        return self.setup_state

    @property
    def facts(self) -> dict:
        return {"acc2": self.acc2}


class Draws:
    """The benchmark's draw source (the reference's frozen copy of the
    program's Philox source): the same numbers for program and reference."""

    def __init__(self, seed: int, dev):
        from ..reference.rng import Rooted, TorchDraws, fold_in

        self._src = TorchDraws(seed, device=dev)
        self._rooted, self._fold_in = Rooted, fold_in

    def at(self, iteration: int, view: int):
        f = self._fold_in
        return self._rooted(self._src, f(f((), iteration), view))


def reference_pass(plan: Plan, cfg: dict, sc, state: dict, rnd: int, p: int,
                   v: int, iteration: int, draws: Draws, dev):
    """The reference's state of view ``v`` after the pass, from the
    set-up's ``state`` of every view."""
    from ..reference import config as rc
    from ..reference.geometry.camera import Camera
    from ..reference.view_pass import ReferenceRunner, ViewState

    base = rc.PMStatic(**base_settings(cfg))
    cams = {u: Camera.create(**sc.cameras[u]) for u in plan.views}
    st = {u: ViewState(s.depth, s.normal_world, s.weak, s.sel_views,
                       s.radius) for u, s in state.items()}
    runner = ReferenceRunner({u: sc.images[u] for u in plan.views}, cams,
                             sources_of(plan.views), st, base, dev)
    static, dyn = rc.round_pass_params(rnd, plan.rounds, p, base, 0.0, 1.0)
    return runner.view_pass(v, static, dyn, plan.scale(rnd),
                            draws.at(iteration, v))


def make_inputs(plan: Plan, cfg: dict, seed: int, card=None):
    """The cell's synthetic scene at the round's size (on the host)."""
    return make_scene(num_views=len(plan.views), height=plan.height,
                      width=plan.width, seed=seed % 2 ** 63,
                      **cfg["scene"])


def set_up(plan: Plan, cfg: dict, sc, seed: int, card) -> System:
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


def install_spans(tracer) -> None:
    """``engine/run_pass`` (timed), the weak machinery's entries and the
    cost kernels' entry points (``trace.py``)."""
    from dvpmvs_torch.kernels import weak
    from dvpmvs_torch.sched import runner as runner_mod

    kernels = {fn: getattr(importlib.import_module(
        f"{PROGRAM}.kernels.{mod}"), fn)
        for mod, fn in trace.KERNEL_ENTRIES.items()}
    tracer.install(runner_mod.run_pass,
                   {f"weak/{fn}": getattr(weak, fn)
                    for fn in trace.WEAK_ENTRIES}, kernels)


def check_passes(plan: Plan, cfg: dict, sc, setup_state: dict, picked,
                 draws: Draws, dev):
    """Each picked pass made again by the reference and compared:
    {name: {"value", "limit"}} and the count of passes not correct."""
    checks, failed = {}, 0
    for p, v, it, got in picked:
        want = reference_pass(plan, cfg, sc, setup_state, plan.round, p, v,
                              it, draws, dev)
        nums = check_mod.numbers(got, want)
        failed += not check_mod.verdict(nums)
        for k, x in nums.items():
            checks[f"{KIND_NAMES.get(p, p)}.{k}"] = {
                "value": x, "limit": check_mod.LIMITS[k]}
    return checks, failed


def check(plan: Plan, cfg: dict, sc, setup_state: dict, picked, seed: int,
          card):
    return check_passes(plan, cfg, sc, setup_state, picked,
                        Draws(seed, card.dev), card.dev)


def control(torch, cell, seed: int, card) -> dict:
    """The program's and the control's numbers on one seed's passes: one
    window pass of each kind, the reference, and the reference with its
    cost kernels in bfloat16 storage (``control.bf16_kernels``)."""
    from .. import run
    from ..control import bf16_kernels

    plan = Plan(cell)
    cfg = cell.config
    sc = make_inputs(plan, cfg, seed, card)
    system = set_up(plan, cfg, sc, seed, card)
    _, _, done = run.run_window(system, 0.0, n_max=len(plan.kinds))
    setup_state = system.setup_state
    del system
    card.free()
    out = {"seed": seed, "program": {}, "control": {}}
    draws = Draws(seed, card.dev)
    for p, v, it, got in done:
        kind = KIND_NAMES.get(p, p)
        t0 = time.perf_counter()
        want = reference_pass(plan, cfg, sc, setup_state, plan.round, p,
                              v, it, draws, card.dev)
        t1 = time.perf_counter()
        with bf16_kernels(torch):
            low = reference_pass(plan, cfg, sc, setup_state, plan.round,
                                 p, v, it, draws, card.dev)
        out["program"][kind] = check_mod.numbers(got, want)
        out["control"][kind] = check_mod.numbers(low, want)
        out.setdefault("reference_s", {})[kind] = t1 - t0
    return out
