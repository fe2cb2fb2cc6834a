"""The benchmark's own tests: ``python -m pytest mvsbench/tests`` from the
root of the repository.  They run on the CPU, on tiny cells made as files
in a temporary copy of the benchmark; a test that needs the card is marked
``cuda``."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def tiny_config(name="eth3d-highres", **kw) -> dict:
    """A configuration's file cut to a CPU test's size: 96x128 images with
    a base size of 64 (two rounds), 4 views, one iteration."""
    cfg = json.loads((REPO / "mvsbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update({"image_width": 128, "image_height": 96,
                "max_base_size": 64, "views": 4, "iterations": 1, **kw})
    return cfg


@pytest.fixture
def torch_cpu():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield torch
    torch.set_num_threads(n)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and mvsbench/ (what a checkout of the
    benchmark holds), to add files and entries to."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "mvsbench", tmp_path / "mvsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path
