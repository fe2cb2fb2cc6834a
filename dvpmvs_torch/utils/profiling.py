"""Tracing and metrics (counterpart of ``dvpmvs/utils/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where
    there is one, the card, written as a Chrome trace to
    ``<logdir>/trace.json``;
  * ``annotate(name)``: a span, the one way the program opens one (and
    ``spanned(name)``, which makes every call of a function one).  While no
    ``torch.profiler`` records it is a shared no-op context after one read
    of the profiler's flag: it records, launches and allocates nothing.
    While one records, it is a profiler range of that name (a ``cpu_op``
    in the Chrome trace) and an entry of the in-memory record: name, start
    and end on the profiler's clock, the enclosing span and the view pass;
  * ``count(name, value)``: a counter of the record, kept only while a
    profiler records; a tensor is kept as given (a mask, say), with no
    launch and no copy;
  * ``recorded()`` / ``reset()``: the record's spans and counts (each
    tensor summed, and a device's sums copied to the host in one go) and
    its reset; ``trace`` resets it;
  * ``Metrics``: named wall-clock timings and counters, dumpable to JSON
    (the same class as the JAX package's).

Spans are named ``<layer>/<stage>``.  A span named ``VIEW_PASS`` opens a
view pass: it and every span and count inside it carry its id.  Nothing
here synchronizes the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

VIEW_PASS = "runner/view_pass"


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace context; no-op when logdir is None.  Resets the
    record of spans and counts when it starts."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def recording() -> bool:
    """Whether a ``torch.profiler`` records (the profiler's module flag)."""
    return _autograd_profiler._is_profiler_enabled


@dataclasses.dataclass(frozen=True)
class Span:
    """A recorded span.  Times are ``time.time_ns()``, the clock the
    profiler stamps its events with; ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]        # index of the enclosing span in ``spans``
    view_pass: Optional[int]     # id of the view pass it lies in


@dataclasses.dataclass(frozen=True)
class Count:
    name: str
    value: float
    view_pass: Optional[int]


@dataclasses.dataclass(frozen=True)
class Record:
    """What was recorded while a profiler recorded, spans in start order."""

    spans: Tuple[Span, ...]
    counts: Tuple[Count, ...]

    def total(self, name: str) -> float:
        return sum(c.value for c in self.counts if c.name == name)


class _Record:
    """The record being kept: open spans as mutable entries ``[name,
    start_ns, end_ns, parent, view_pass]``, counts as ``(name, value,
    view_pass)``; each thread nests its own spans."""

    def __init__(self) -> None:
        self.spans: List[list] = []
        self.counts: List[tuple] = []
        self.view_passes = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> List[Tuple[int, Optional[int]]]:
        """This thread's open spans: (index, view pass), innermost last."""
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def view_pass(self) -> Optional[int]:
        st = self.stack()
        return st[-1][1] if st else None


_RECORD = _Record()


def reset() -> None:
    """Forget every recorded span and count."""
    global _RECORD
    _RECORD = _Record()


class _Span:
    """One span while a profiler records: a profiler range of the fast,
    function-scope kind (a user-scope ``record_function`` is mirrored on the
    device's timeline as an operation of its own) and an entry of the
    record, stamped inside the range."""

    __slots__ = ("name", "_range", "_rec", "_entry")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Span":
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        rec = self._rec = _RECORD
        stack = rec.stack()
        parent, vp = stack[-1] if stack else (None, None)
        if self.name == VIEW_PASS:
            vp = next(rec.view_passes)
        self._entry = [self.name, time.time_ns(), None, parent, vp]
        with rec.lock:
            index = len(rec.spans)
            rec.spans.append(self._entry)
        stack.append((index, vp))
        return self

    def __exit__(self, *exc) -> None:
        self._entry[2] = time.time_ns()
        self._rec.stack().pop()
        self._range.__exit__(*exc)


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` (see the module's text)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function is an ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor whose elements are summed when
    the record is read; kept as given until then) to the counter ``name``
    of the record while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORD.counts.append((name, value, _RECORD.view_pass()))


def _host_values(values) -> List[float]:
    """The values as floats: each tensor's sum, each device's sums in one
    copy."""
    out: List[Optional[float]] = [None] * len(values)
    by_device: Dict[torch.device, List[int]] = defaultdict(list)
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_device[v.device].append(i)
        else:
            out[i] = float(v)
    for idx in by_device.values():
        got = torch.stack([values[i].sum(dtype=torch.float64)
                           for i in idx]).tolist()
        for i, x in zip(idx, got):
            out[i] = x
    return out


def recorded() -> Record:
    """The spans and counts recorded since the last ``reset``."""
    rec = _RECORD
    spans = tuple(Span(*e) for e in list(rec.spans))
    counts = list(rec.counts)
    values = _host_values([v for _, v, _ in counts])
    return Record(spans, tuple(Count(n, x, vp) for (n, _, vp), x
                               in zip(counts, values)))


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
