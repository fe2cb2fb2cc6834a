"""Tracing and metrics (counterpart of ``dvpmvs/utils/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where
    there is one, the card, written as a Chrome trace to
    ``<logdir>/trace.json``;
  * ``annotate(name)``: a ``record_function`` span, so scheduler phases
    show as named spans in the trace;
  * ``Metrics``: named wall-clock timings and counters, dumpable to JSON
    (the same class as the JAX package's).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace context; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named span inside a profiler trace."""
    return torch.profiler.record_function(name)


class Metrics:
    """Named wall-clock timings + counters, JSON-dumpable.

    >>> m = Metrics()
    >>> with m.timed("pass/round0"):
    ...     work()
    >>> m.count("views_processed", 13)
    >>> m.dump(path)
    """

    def __init__(self) -> None:
        self.timings: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name].append(time.perf_counter() - t0)

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] += inc

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, vals in self.timings.items():
            out[name] = {"count": len(vals), "total_s": sum(vals),
                         "mean_s": sum(vals) / len(vals),
                         "max_s": max(vals)}
        return {"timings": out, "counters": dict(self.counters)}

    def dump(self, path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=1))
