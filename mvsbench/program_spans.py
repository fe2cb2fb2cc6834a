"""The program's own spans and counters, joined to the device trace.

While a profiler records, the program keeps a record of its spans and
counters (``dvpmvs_torch.utils.profiling``): each span's name
(``<layer>/<stage>``), start and end on the clock the profiler stamps its
events with, the span that encloses it, and the view pass it belongs to
(``runner/view_pass``).  After the traced window the readers here take that
record in process (``recorded()``) and charge the device's idle time to the
stages:

  * the idle intervals are the gaps in the union of the device's operations
    (``trace.TraceRecord.device``) from the start of the first traced
    ``runner/view_pass`` to the end of the last;
  * a stage's idle time is the exact overlap of those gaps with the stage's
    self intervals (each of its spans less the spans inside it), summed
    over the traced passes and divided by their count;
  * what no named stage takes of the device's idle time over the traced
    run's window (``device.idle_share`` x window) is the unspanned rest:
    the self time of ``runner/view_pass``, ``engine/pass`` and
    ``runner/finish``, and the harness's own.

So the stages and the rest add up to the whole idle time.  Where the
program keeps no record (a commit before it had one), or recorded no view
pass, or not as many as the traced run made, every reader gets None.
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Optional, Tuple

from . import measure

PROFILING = "dvpmvs_torch.utils.profiling"
VIEW_PASS = "runner/view_pass"
# the stages a metric reads, by the metric's name
STAGES = {
    "runner.prepare_idle_ms_per_pass": ("runner/prepare",),
    "runner.priors_idle_ms_per_pass": ("runner/priors",),
    "engine.setup_idle_ms_per_pass": ("engine/setup",),
    "engine.propagate_idle_ms_per_pass": ("engine/propagate",),
    "engine.post_idle_ms_per_pass": ("engine/post",),
    "weak.idle_ms_per_pass": ("weak/anchors", "weak/fit", "weak/propagate"),
}

Interval = Tuple[int, int]


def program_record():
    """The program's record of the traced window, or None where it keeps
    none."""
    try:
        profiling = importlib.import_module(PROFILING)
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded()


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of [a, b) intervals as sorted disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap(xs: List[Interval], ys: List[Interval]) -> int:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_intervals(spans) -> Dict[str, List[Interval]]:
    """Each span name's self intervals: its spans less the spans whose
    parent they are, merged over the spans of the name."""
    children: Dict[int, List[Interval]] = {}
    for s in spans:
        if s.parent is not None and s.end_ns is not None:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    by_name: Dict[str, List[Interval]] = {}
    for i, s in enumerate(spans):
        if s.end_ns is None:
            continue
        own, at = by_name.setdefault(s.name, []), s.start_ns
        for a, b in merge(children.get(i, ())):
            if a > at:
                own.append((at, min(a, s.end_ns)))
            at = max(at, b)
        if s.end_ns > at:
            own.append((at, s.end_ns))
    return {n: merge(iv) for n, iv in by_name.items()}


def view_passes(rec, prog):
    """The program's traced view passes; None where it recorded none, or
    not as many as the traced run made."""
    if prog is None:
        return None
    passes = [s for s in prog.spans
              if s.name == VIEW_PASS and s.end_ns is not None]
    return passes if passes and len(passes) == rec.n_passes else None


def idle_by_stage(rec, prog) -> Optional[Dict[str, float]]:
    """Device idle ns by span name, over the program's traced view passes;
    None where the program's record does not match the traced run."""
    passes = view_passes(rec, prog)
    if passes is None:
        return None
    lo = min(s.start_ns for s in passes)
    hi = max(s.end_ns for s in passes)
    inside = [(max(op.start_ns, lo), min(op.end_ns, hi)) for op in rec.device
              if op.end_ns > lo and op.start_ns < hi]
    gaps = measure.idle_gaps(inside, lo, hi)
    return {name: float(overlap(iv, gaps))
            for name, iv in self_intervals(prog.spans).items()}


def stage_idle_ms(rec, metric: str, prog=None) -> Optional[float]:
    """Device idle ms a traced pass in the stages ``metric`` reads; None
    where none of them ran."""
    prog = program_record() if prog is None else prog
    idle = idle_by_stage(rec, prog)
    if idle is None or not any(n in idle for n in STAGES[metric]):
        return None
    return sum(idle.get(n, 0.0) for n in STAGES[metric]) * 1e-6 / (
        rec.n_passes)


def unspanned_idle_ms(rec, prog=None) -> Optional[float]:
    """Device idle ms a traced pass over the traced run's window that no
    stage of ``STAGES`` takes."""
    prog = program_record() if prog is None else prog
    idle = idle_by_stage(rec, prog)
    if idle is None:
        return None
    staged = sum(idle.get(n, 0.0) for names in STAGES.values()
                 for n in names)
    whole = (rec.window_s - rec.busy_s) * 1e9
    return (whole - staged) * 1e-6 / rec.n_passes


def _kept(rec, prog) -> Optional[set]:
    """The names of the counters the program kept in the traced passes."""
    if view_passes(rec, prog) is None:
        return None
    return {c.name for c in prog.counts}


def count_per_pass(rec, name: str, prog=None) -> Optional[float]:
    """The counter ``name`` a traced pass; None where it was not kept."""
    prog = program_record() if prog is None else prog
    kept = _kept(rec, prog)
    if kept is None or name not in kept:
        return None
    return prog.total(name) / rec.n_passes


def share(rec, part: str, whole: str, prog=None) -> Optional[float]:
    """Counter ``part`` over counter ``whole``; None where ``whole`` was not
    kept or is 0."""
    prog = program_record() if prog is None else prog
    kept = _kept(rec, prog)
    if kept is None or whole not in kept or not prog.total(whole):
        return None
    return prog.total(part) / prog.total(whole)
