"""One run of one cell: set-up, the measured window, the check.

    python3 -m mvsbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

What the window drives is the traffic's stage (``stages/<stage>.py``,
found by name; ``view_pass`` where the traffic names none): set-up makes
its inputs from the seed and its program objects, with one warm pass of
each kind; the window then runs the stage's passes one after another,
each restored after it, until ``--seconds`` have elapsed, and ends when
the last one returns.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profile of the window's first
passes (the stage's ``trace_passes``).  Either way, once the window is over
and the program's objects are freed, one pass of each kind, drawn from the
seed among those the window ran, is made again by the stage's plain
reference on the card from the same inputs and compared.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import List

import numpy as np

from . import cells as cells_mod

PROGRAM = "dvpmvs_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "dvpmvs")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


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


def run_window(system, seconds: float, n_max=None, on_pass=None):
    """The measured window: (pass walls, window seconds, the passes as the
    stage's ``Pass.finish`` gives them, kind first)."""
    walls, done = [], []
    t0 = t1 = time.perf_counter()
    k = 0
    while (k < n_max if n_max is not None
           else (k == 0 or time.perf_counter() - t0 < seconds)):
        ps = system.window_pass(k)
        a = time.perf_counter()
        if on_pass is None:
            ps.call()
        else:
            on_pass(ps.call)
        t1 = time.perf_counter()
        walls.append(t1 - a)
        done.append(ps.finish())
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


def traced_window(torch, stage, plan, system, card: Card):
    """The window's first ``trace_passes`` passes under the profiler, with
    the stage's spans installed: (TraceRecord, passes)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import dvpmvs_torch

    from . import trace

    tracer = trace.Tracer(torch, PROGRAM, card.sync, *stage.WORK)
    stage.install_spans(tracer)

    def one(fn):
        with record_function(trace.PREFIX + stage.OUTER_SPAN):
            fn()

    try:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if card.is_cuda else [])
        with profile(activities=acts) as prof:
            walls, window_s, done = run_window(
                system, 0.0, n_max=plan.trace_passes, on_pass=one)
            card.sync()
    finally:
        tracer.remove()
    tracer.finish_counts()
    rec = tracer.record(prof, trace.program_kernel_names(
        Path(dvpmvs_torch.__file__).parent), stage.OUTER_SPAN,
        stage.PROGRAM_SPAN)
    del prof
    return rec, done


def run_cell(torch, cell: cells_mod.Cell, seed: int, seconds: float,
             trace_on: bool, card: Card, started: float,
             n_max=None) -> dict:
    """One run of ``cell``: its result line as a dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, and ``checks``
    last), after printing the checks on standard error.  ``n_max``, where
    given, fixes the untraced window's passes in place of ``seconds``."""
    cfg = cell.config
    stage = cells_mod.stage_module(cell)
    plan = stage.Plan(cell)
    if card.is_cuda:
        from dvpmvs_torch.kernels import _build
        _build.build_all()
    inputs = stage.make_inputs(plan, cfg, seed, card)
    system = stage.set_up(plan, cfg, inputs, seed, card)
    setup_s = time.perf_counter() - started

    if trace_on:
        rec, done = traced_window(torch, stage, plan, system, card)
    else:
        walls, window_s, done = run_window(system, seconds, n_max)
    card.sync()
    peak = card.peak_bytes()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"mvsbench: the run loaded {', '.join(bad)}")

    kept, facts = system.kept, system.facts
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
              f"the program's kernels, {inside} of those inside the "
              f"kernel spans; launch times from {rec.launch_times}",
              file=sys.stderr)
    else:
        win = Window(walls, window_s, setup_s)
        extra["pass_s"] = walls
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": cells_mod.metric_reader(m["name"])(win),
                "unit": m["unit"]}

    checks, failed = stage.check(plan, cfg, inputs, kept, picked, seed,
                                 card)
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
            **extra, **facts, "card": card_text, "checks": checks}


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
