"""The traced run's spans and the reading of the profiler's events.

Spans come from the benchmark's own wrappers, installed only in a traced
run: each wraps a name the program calls, in every module of the program
that binds it, so the program's own lookups go through the wrapper.  The
stage a traced run drives (``stages/``) names its outer span and what it
wraps (``Tracer.install``); the defaults here are the view pass's:

  runner/run_view_pass    the harness's call of ``SceneRunner.run_view_pass``
                          (the stage's ``OUTER_SPAN``)
  engine/run_pass         ``run_pass`` as the runner calls it (the timed
                          span); it ends in a synchronize, so the runner's
                          share of a pass is the host wall of the view pass
                          less this one
  weak/<fn>               ``find_anchors``, ``ransac_fit_plane`` (plain
                          spans)
  kernels/<fn>#<i>        the i-th call of a cost kernel's entry point
                          (``KERNEL_ENTRIES``), with its operations and bytes
                          counted from its arguments (``_work``,
                          ``measure.py``); the device is synchronized before
                          the call and at its end, so what runs on it inside
                          the span is what the call launched

The profiler records the host's operations and the device's; every device
operation is charged to the innermost spans active on the host when it was
launched, found through the launch's correlation id.  Everything is read in
memory from the profiler's raw events; nothing is written to disk.
"""

from __future__ import annotations

import dataclasses
import inspect
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from . import measure, program_spans

PREFIX = "mvsbench:"
OUTER_SPAN = "runner/run_view_pass"
WEAK_ENTRIES = ("find_anchors", "ransac_fit_plane")
# the cost kernels' entry points, by the module of ``kernels/`` that holds
# each (the program's and the reference's alike)
KERNEL_ENTRIES = {"ncc_fused": "fused_ncc_costs",
                  "sweep_fused": "sweep_weighted_ncc",
                  "geom_fused": "geom_cost",
                  "anchor_fused": "anchor_slot_costs",
                  "warp_fused": "warp_ncc"}


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    kind: str
    spans: Tuple[str, ...]       # benchmark spans active at its launch


@dataclasses.dataclass
class KernelCall:
    fn: str
    span: str
    ops: float
    nbytes: float
    bound_s: float
    bound_by: str
    device_s: float = 0.0


@dataclasses.dataclass
class TraceRecord:
    """What a per-layer metric reads: the traced passes, the device's
    operations in them, the cost kernels' calls, the program's kernel
    names (``__global__`` functions of its ``csrc/``)."""

    n_passes: int
    view_pass_s: List[float]
    run_pass_s: List[float]
    device: List[DeviceOp]
    calls: List[KernelCall]
    program_kernels: Tuple[str, ...]
    window_s: float
    busy_s: float
    idle_by_span: Dict[str, float]
    launch_times: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the program's span that bounds a traced pass (``program_spans.py``)
    program_span: str = program_spans.VIEW_PASS


def program_kernel_names(package_dir: Path) -> Tuple[str, ...]:
    """The ``__global__`` functions of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)")
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return tuple(sorted(names))


def program_kernel_pattern(names: Tuple[str, ...]):
    """A regex that finds the program's kernels by whole name in the
    profiler's (demangled) kernel names; None where there are none."""
    if not names:
        return None
    return re.compile(r"\b(?:%s)\b" % "|".join(map(re.escape, names)))


def _work(fn: str, a: dict) -> Tuple[float, float, Optional[object]]:
    """(operations, bytes, deferred) of one call from its bound arguments;
    K4's counts of usable anchors are read from ``vbits`` after the traced
    passes (``deferred``), so that counting launches nothing inside them."""
    if fn == "fused_ncc_costs":
        B, Hp, Wp = a["planes"].shape[:3]
        V, H, W = a["src"].shape
        return (*measure.k1_work(B, Hp, Wp, V, H, W,
                                 a["radius_map"] is not None), None)
    if fn == "sweep_weighted_ncc":
        V = a["src"].shape[0]
        Ho, W = a["wsums"].shape[1:]
        return (*measure.k2_work(int(a["K"]), Ho, W, V), None)
    if fn == "geom_cost":
        K, Hp, Wp = a["depth_stack"].shape[:3]
        V, H, W = a["gctx"].src_depths.shape
        return (*measure.k3_work(K, Hp, Wp, V, H, W, bool(a["fold"])), None)
    if fn == "anchor_slot_costs":
        S, K = a["q"].shape[:2]
        A = a["rax"].shape[0]
        V, H, W = a["src"].shape
        taps = a["tap_words"]
        n_taps = 0 if taps is None else int(taps.shape[1])
        return 0.0, 0.0, (S, K, V, A, H, W, n_taps, a["vbits"])
    if fn == "warp_ncc":
        B, Hin, W = a["planes"].shape[:3]
        V, H = a["src"].shape[:2]
        return (*measure.warp_ncc_work(B, Hin, W, V, H), None)
    raise KeyError(fn)


def _k4_counts(deferred) -> Tuple[float, float]:
    S, K, V, A, H, W, n_taps, vbits = deferred
    n_weak = int((vbits != 0).any(0).sum())
    n_kv = sum(int(((vbits >> v) & 1).any(0).sum()) for v in range(V))
    return measure.k4_work(S, K, V, A, H, W, n_weak, n_kv, n_taps)


class Tracer:
    """Installs the spans in the program's modules (``install``) and takes
    them out again (``remove``); ``record`` reads a finished profile.
    ``work(fn, bound arguments)`` gives a kernel call's (operations, bytes,
    deferred); ``deferred_work(deferred)`` its operations and bytes once the
    traced passes are over."""

    def __init__(self, torch, package: str, sync: Callable[[], None],
                 work=_work, deferred_work=_k4_counts):
        self.torch = torch
        self.package = package
        self.sync = sync
        self.work = work
        self.deferred_work = deferred_work
        self.calls: List[KernelCall] = []
        self._deferred: Dict[int, object] = {}
        self.run_pass_s: List[float] = []
        self._patched: List[Tuple[object, str, object]] = []

    def _bind(self, original, wrapper) -> None:
        for name, mod in list(sys.modules.items()):
            if mod is None or not (name == self.package
                                   or name.startswith(self.package + ".")):
                continue
            for attr, val in list(vars(mod).items()):
                if val is original:
                    self._patched.append((mod, attr, original))
                    setattr(mod, attr, wrapper)

    def _span(self, name: str):
        return self.torch.profiler.record_function(PREFIX + name)

    def install(self, timed=None, plain: Dict[str, object] = None,
                kernels: Dict[str, object] = None) -> None:
        """Spans around ``timed`` (``engine/run_pass``, its host wall taken
        to a synchronize, into ``run_pass_s``), around each function of
        ``plain`` (by span name) and around each of ``kernels``
        (``kernels/<fn>#<i>``, by entry point, counted by ``work``)."""
        tracer = self

        def timed_run_pass(*args, **kwargs):
            with tracer._span("engine/run_pass"):
                t0 = time.perf_counter()
                out = timed(*args, **kwargs)
                tracer.sync()
                tracer.run_pass_s.append(time.perf_counter() - t0)
            return out

        if timed is not None:
            self._bind(timed, timed_run_pass)
        for name, original in (plain or {}).items():
            self._bind(original, self._plain_span(name, original))
        for fn, original in (kernels or {}).items():
            self._bind(original, self._kernel_span(fn, original))

    def _plain_span(self, name: str, original):
        def wrapper(*args, **kwargs):
            with self._span(name):
                return original(*args, **kwargs)
        return wrapper

    def _kernel_span(self, fn: str, original):
        sig = inspect.signature(original)

        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            ops, nbytes, deferred = self.work(fn, bound.arguments)
            i = len(self.calls)
            span = f"kernels/{fn}#{i}"
            self.calls.append(KernelCall(fn, PREFIX + span, ops, nbytes,
                                         *measure.bound_s(ops, nbytes)))
            if deferred is not None:
                self._deferred[i] = deferred
            self.sync()
            with self._span(span):
                out = original(*args, **kwargs)
                self.sync()
            return out
        return wrapper

    def remove(self) -> None:
        for mod, attr, original in reversed(self._patched):
            setattr(mod, attr, original)
        self._patched.clear()

    def finish_counts(self) -> None:
        """The deferred calls' operations and bytes (K4's, from the usable
        anchors of its calls)."""
        for i, deferred in self._deferred.items():
            c = self.calls[i]
            c.ops, c.nbytes = self.deferred_work(deferred)
            c.bound_s, c.bound_by = measure.bound_s(c.ops, c.nbytes)
        self._deferred.clear()

    def record(self, prof, program_kernels: Tuple[str, ...],
               outer: str = OUTER_SPAN,
               program_span: str = program_spans.VIEW_PASS) -> TraceRecord:
        return read_events(prof.profiler.kineto_results.events(),
                           self.calls, self.run_pass_s, program_kernels,
                           outer, program_span)


def _kind(name: str) -> str:
    """A device operation's kind from its profiler name."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def read_events(events, calls: List[KernelCall], run_pass_s: List[float],
                program_kernels: Tuple[str, ...], outer: str = OUTER_SPAN,
                program_span: str = program_spans.VIEW_PASS) -> TraceRecord:
    """A TraceRecord from the profiler's raw events (``_KinetoEvent``); a
    traced pass is a span ``outer`` of the benchmark's.

    A device operation is launched at the host time of its CUDA runtime
    call (the host event of the same correlation id, named ``cuda...`` or
    ``cu...``); failing that, at the start of the host operation it links
    to (``linked_correlation_id``); failing both, at its own start, which
    lies inside the launching span where the span synchronizes the device
    at both ends (the cost kernels' spans do).  The profiler's own ranges
    mirrored on the device are not device operations."""
    spans, runtime, starts, device = [], {}, {}, []
    for ev in events:
        name = ev.name()
        if str(ev.device_type()).endswith("CPU"):
            if name.startswith(PREFIX):
                spans.append((ev.start_ns(), ev.end_ns(), name))
            if _RUNTIME.match(name):
                runtime[ev.correlation_id()] = ev.start_ns()
            elif ev.linked_correlation_id() == 0:
                starts[ev.correlation_id()] = ev.start_ns()
        elif not name.startswith(PREFIX) and ev.duration_ns() >= 0:
            device.append(ev)
    spans.sort()
    passes = [(a, b) for a, b, n in spans if n == PREFIX + outer]
    if not passes:
        raise RuntimeError(f"the profile holds no traced pass ({outer})")
    lo, hi = passes[0][0], max(b for _, b in passes)

    points, how = [], {"runtime": 0, "operation": 0, "own start": 0}
    for i, ev in enumerate(device):
        t = runtime.get(ev.correlation_id())
        if t is not None:
            how["runtime"] += 1
        else:
            t = starts.get(ev.linked_correlation_id())
            how["operation" if t is not None else "own start"] += 1
        points.append((ev.start_ns() if t is None else t, i))
    stacks = stab(spans, points)
    ops = [DeviceOp(ev.name(), ev.start_ns(), ev.end_ns(), _kind(ev.name()),
                    stacks[i]) for i, ev in enumerate(device)]
    by_span: Dict[str, float] = {}
    for op in ops:
        for s in op.spans:
            by_span[s] = by_span.get(s, 0.0) + (op.end_ns - op.start_ns)
    for c in calls:
        c.device_s = by_span.get(c.span, 0.0) * 1e-9
    inside = [(max(op.start_ns, lo), min(op.end_ns, hi)) for op in ops
              if op.end_ns > lo and op.start_ns < hi]
    gaps = measure.idle_gaps(inside, lo, hi)
    at = stab(spans, [((a + b) // 2, i) for i, (a, b) in enumerate(gaps)])
    idle: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        label = span_label(at[i][-1]) if at[i] else "outside the spans"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return TraceRecord(
        n_passes=len(passes),
        view_pass_s=[(b - a) * 1e-9 for a, b in passes],
        run_pass_s=list(run_pass_s), device=ops, calls=list(calls),
        program_kernels=program_kernels, window_s=(hi - lo) * 1e-9,
        busy_s=measure.union_length(inside) * 1e-9, idle_by_span=idle,
        launch_times=how, program_span=program_span)


def span_label(name: str) -> str:
    """A span's name without the prefix and a call's number."""
    return name[len(PREFIX):].split("#")[0]


def stab(spans: List[Tuple[int, int, str]], points: List[Tuple[int, int]]
         ) -> Dict[int, Tuple[str, ...]]:
    """For each (time, key) in ``points`` the names of the spans (sorted by
    start, properly nested) that hold the time, outermost first."""
    out: Dict[int, Tuple[str, ...]] = {}
    stack: List[Tuple[int, int, str]] = []
    cur: Tuple[str, ...] = ()
    si = 0
    for t, key in sorted(points):
        changed = False
        while si < len(spans) and spans[si][0] <= t:
            while stack and stack[-1][1] <= spans[si][0]:
                stack.pop()
            stack.append(spans[si])
            si += 1
            changed = True
        while stack and stack[-1][1] <= t:
            stack.pop()
            changed = True
        if changed:
            cur = tuple(s[2] for s in stack)
        out[key] = cur
    return out


def breakdown(rec: TraceRecord) -> dict:
    """The ten device operations that took the most time, and the device's
    idle time by the innermost benchmark span active on the host, in
    seconds over the traced passes."""
    by_name: Dict[str, int] = {}
    for op in rec.device:
        by_name[op.name] = by_name.get(op.name, 0) + (op.end_ns - op.start_ns)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(rec.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, ns * 1e-9] for n, ns in top],
            "idle_gaps": [[n, s] for n, s in idle]}
