"""Finds a cell's configuration, traffic and metrics by name.

``BENCHMARK.json`` at the root of the checkout names every cell
(``workloads``), its configuration (``configs``: a file under
``mvsbench/configs/``) and its traffic (``mvsbench/traffic/<traffic>.json``),
and every metric; a per-layer metric is read by ``mvsbench/metrics/<name>.py``.
The traffic names the stage its window drives (``stage``, ``view_pass``
where it names none), which ``mvsbench/stages/<stage>.py`` supplies.  A new
cell, configuration, traffic mix, stage or per-layer metric is new files
and new entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
DEFAULT_STAGE = "view_pass"
STAGE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (PACKAGE_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str) -> Callable[[object], Optional[float]]:
    """``read`` of ``mvsbench/metrics/<name>.py``: a traced run's record to
    the metric's value, or None where the record holds nothing to read."""
    path = PACKAGE_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"mvsbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def stage_module(cell: Cell):
    """The module ``mvsbench/stages/<stage>.py`` of the stage the cell's
    traffic names (``view_pass`` where it names none)."""
    name = cell.traffic.get("stage", DEFAULT_STAGE)
    if not STAGE_NAME.match(name):
        raise ValueError(f"stage {name!r} is not a module name")
    return importlib.import_module(f"{__package__}.stages.{name}")
