"""BENCHMARK.json against the benchmark's contract, discovery by name, a
throwaway cell added as files to a copy, and the import guard."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from conftest import REPO, tiny_config

from mvsbench import cells

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "dvpmvs"}


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("mvsbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg) and cfg["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "mvsbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        mine = [m for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in mine}
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (REPO / "mvsbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", names)) <= set(names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_cells_are_found_by_name():
    for w in BENCH["workloads"]:
        cell = cells.load_cell(REPO, w["name"])
        assert cells.stage_module(cell).Plan(cell).trace_passes >= 1
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))


def test_a_throwaway_cell_runs_from_new_files_alone(bench_copy):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and entries to a copy run with no edit of what is there."""
    before = {p: p.read_bytes() for p in (bench_copy / "mvsbench").rglob("*")
              if p.is_file()}
    cfg = tiny_config("tnt-intermediate")
    (bench_copy / "mvsbench/configs/tiny.json").write_text(json.dumps(cfg))
    (bench_copy / "mvsbench/traffic/tiny-mix.json").write_text(json.dumps(
        {"round": 1, "setup": [[0, 0]], "window": [0], "trace_passes": 1}))
    (bench_copy / "mvsbench/metrics/passes.traced.py").write_text(
        "def read(rec):\n    return float(rec.n_passes)\n")
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "mvsbench/configs/tiny.json",
                             "reduced": cfg["reduced"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "passes.traced", "unit": "passes",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["tiny.cell"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from mvsbench import cells, run\n"
        "cell = cells.load_cell(Path.cwd(), 'tiny.cell')\n"
        "line = run.run_cell(torch, cell, 2**31 + 99, 0.0, True,\n"
        "                    run.Card(torch, torch.device('cpu')),\n"
        "                    time.perf_counter())\n"
        "print(json.dumps(line))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(bench_copy), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=bench_copy,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["passes.traced"]["value"] == 1.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _imports(path: Path):
    """(absolute module, level) of every import in a source file."""
    tree = ast.parse(path.read_text())
    rel = path.relative_to(REPO).with_suffix("")
    pkg = list(rel.parts[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
            else:
                base = pkg[:len(pkg) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
                yield mod


def test_import_guard():
    """Nothing of the benchmark imports JAX or the JAX package, by whole
    top-level names; the yardstick (reference, scene, arithmetic,
    comparison, control's rounding) imports nothing of the program."""
    yardstick = ("mvsbench/reference/", "mvsbench/scene.py",
                 "mvsbench/measure.py", "mvsbench/check.py",
                 "mvsbench/metrics/")
    files = sorted((REPO / "mvsbench").rglob("*.py"))
    assert files
    for f in files:
        mods = list(_imports(f))
        tops = {m.split(".")[0] for m in mods}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)
        rel = f.relative_to(REPO).as_posix()
        if rel.startswith(yardstick):
            assert "dvpmvs_torch" not in tops, rel
        if rel.startswith("mvsbench/reference/"):
            assert all(m.startswith("mvsbench.reference") or
                       m.split(".")[0] in ("torch", "numpy", "scipy",
                                           "__future__", "typing",
                                           "dataclasses", "math", "enum",
                                           "hashlib")
                       for m in mods), (rel, mods)
