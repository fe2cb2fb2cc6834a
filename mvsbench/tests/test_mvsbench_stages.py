"""Stages: a throwaway stage (``prior_stage.py``, a Depth-Anything-V2
forward) added as new files and entries to a copy of the benchmark runs
untraced and traced with no byte of an existing file changed, and reads
not correct with a fault planted in its output; and the view-pass stage
reads on a tiny cell what the harness read before stages existed."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import REPO, tiny_config

from dvpmvs_torch.utils import profiling
from mvsbench import cells, program_spans, run

HERE = os.path.dirname(os.path.abspath(__file__))
TINY_DA = {"patch_size": 14, "embed_dim": 32, "depth": 2, "num_heads": 2,
           "mlp_ratio": 4.0, "out_indices": [0, 0, 1, 1],
           "dpt_features": 16, "dpt_out_channels": [8, 8, 16, 16]}
RUN = (
    "import json, sys, time, torch\n"
    "torch.set_num_threads(2)\n"
    "from pathlib import Path\n"
    "from mvsbench import cells, run\n"
    "if sys.argv[2] == 'fault':\n"
    "    from dvpmvs_torch.priors import depth_anything as da\n"
    "    real = da.DepthAnythingV2.forward\n"
    "    da.DepthAnythingV2.forward = lambda self, img: real(self, img) * 1.25\n"
    "cell = cells.load_cell(Path.cwd(), 'tiny.prior')\n"
    "line = run.run_cell(torch, cell, 2**31 + 5, 0.0, sys.argv[1] == '1',\n"
    "                    run.Card(torch, torch.device('cpu')),\n"
    "                    time.perf_counter())\n"
    "print(json.dumps(line))\n")


@pytest.fixture
def prior_copy(bench_copy):
    """The copy with the throwaway stage, its configuration, traffic, cell
    and two per-layer metrics added; the bytes of each file that was under
    ``mvsbench/`` before."""
    before = {p: p.read_bytes() for p in (bench_copy / "mvsbench").rglob("*")
              if p.is_file()}
    mv = bench_copy / "mvsbench"
    shutil.copy(os.path.join(HERE, "prior_stage.py"),
                mv / "stages" / "prior_tiny.py")
    (mv / "configs" / "da-tiny.json").write_text(json.dumps(
        {"model": TINY_DA, "reduced": []}))
    (mv / "traffic" / "prior-batch.json").write_text(json.dumps(
        {"stage": "prior_tiny", "batch": 2, "height": 56, "width": 70,
         "trace_passes": 2}))
    (mv / "metrics" / "prior.linear_calls_per_pass.py").write_text(
        "def read(rec):\n"
        "    n = sum(c.fn == '_linear' for c in rec.calls)\n"
        "    return n / rec.n_passes if n else None\n")
    (mv / "metrics" / "prior.program_passes.py").write_text(
        "from mvsbench.program_spans import program_record, view_passes\n"
        "def read(rec):\n"
        "    passes = view_passes(rec, program_record())\n"
        "    return None if passes is None else float(len(passes))\n")
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "da-tiny", "source": "a test",
                             "file": "mvsbench/configs/da-tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.prior", "config": "da-tiny",
                               "traffic": "prior-batch", "chips": 1,
                               "why": "a test"})
    for name in ("prior.linear_calls_per_pass", "prior.program_passes"):
        bench["per_layer"].append({
            "name": name, "unit": "n", "better": "lower",
            "source": "device_trace", "layer": "prior",
            "moves": "view_passes_per_s", "workloads": ["tiny.prior"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_copy, before


def _run(copy, traced, fault=False):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(copy),
                                                       str(REPO)]))
    out = subprocess.run(
        [sys.executable, "-c", RUN, "1" if traced else "0",
         "fault" if fault else "sound"], cwd=copy, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_throwaway_stage_runs_from_new_files_alone(prior_copy):
    copy, before = prior_copy
    line = _run(copy, traced=False)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"view_passes_per_s", "setup_s"}
    assert list(line["checks"]) == ["forward.depth_gap"]
    gap = line["checks"]["forward.depth_gap"]
    assert 0 < gap["value"] <= gap["limit"]
    traced = _run(copy, traced=True)
    assert traced["correct"] is True and traced["attempted"] == 2
    got = {k: v["value"] for k, v in traced["metrics"].items()}
    # 2 blocks of qkv, proj, fc1, fc2 a forward
    assert got == {"prior.linear_calls_per_pass": 8.0,
                   "prior.program_passes": 2.0}
    assert traced["device"]["window_s"] > 0
    assert {p: p.read_bytes() for p in before} == before


def test_a_fault_in_the_throwaway_stage_output_is_not_correct(prior_copy):
    copy, _ = prior_copy
    line = _run(copy, traced=False, fault=True)
    assert line["correct"] is False and line["failed"] == 1
    gap = line["checks"]["forward.depth_gap"]
    assert gap["value"] > gap["limit"]


# The view pass before stages existed (the harness of commit 1cfa1b1, on
# the CPU): a round-1 cell of two views at 72 x 96, set-up round 0's
# FIRST_INIT and round 1's REFINE_INIT, the window REFINE_INIT and the
# first geometric pass.
VIEW_TRAFFIC = {"round": 1, "setup": [[0, 0], [1, 0]], "window": [0, 1],
                "trace_passes": 2}
VIEW_SEED = 2 ** 31 + 17
BEFORE_CHECKS = {"init.mismatch_px": 0.0, "init.depth_off_share": 0.0,
                 "geom1.mismatch_px": 0.0, "geom1.depth_off_share": 0.0}
BEFORE_ACC2 = 0.6712053571428571
BEFORE_COUNTS = {"runner.view_hits": 4.0, "runner.views": 4.0,
                 "weak.pixels": 1510.0, "weak.reliable": 140.0}


def _view_cell():
    return cells.Cell(
        "tiny.r1", 1, tiny_config(views=2, image_width=96, image_height=72),
        VIEW_TRAFFIC,
        [{"name": "view_passes_per_s", "unit": "view-passes/s"},
         {"name": "setup_s", "unit": "s"}],
        [{"name": "weak.pixels_per_pass", "unit": "px"},
         {"name": "runner.view_hit_share", "unit": "share"}])


def _checks(line):
    return {k: c["value"] for k, c in line["checks"].items()}


def test_the_view_pass_reads_as_before(torch_cpu):
    line = run.run_cell(torch_cpu, _view_cell(), VIEW_SEED, 0.0, False,
                        run.Card(torch_cpu, torch.device("cpu")),
                        time.perf_counter(), n_max=3)
    assert line["correct"] is True and line["attempted"] == 3
    assert _checks(line) == BEFORE_CHECKS
    assert list(line["checks"]) == list(BEFORE_CHECKS)
    assert line["acc2"] == BEFORE_ACC2


def test_the_traced_view_pass_counts_as_before(torch_cpu):
    profiling.reset()
    line = run.run_cell(torch_cpu, _view_cell(), VIEW_SEED, 0.0, True,
                        run.Card(torch_cpu, torch.device("cpu")),
                        time.perf_counter())
    prog = program_spans.program_record()
    profiling.reset()
    assert line["correct"] is True and line["attempted"] == 2
    assert _checks(line) == BEFORE_CHECKS
    assert sum(s.name == program_spans.VIEW_PASS for s in prog.spans) == 2
    assert {n: prog.total(n) for n in BEFORE_COUNTS} == BEFORE_COUNTS
    assert {k: v["value"] for k, v in line["metrics"].items()} == {
        "weak.pixels_per_pass": 755.0, "runner.view_hit_share": 1.0}
