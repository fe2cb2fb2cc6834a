"""The readers of the program's own spans and counters
(``program_spans.py``): self time and the exact overlap of the device's
gaps with it, the stages and the rest adding up to the idle time of the
traced window, nothing where there is nothing to read, and a tiny traced
run on the CPU."""

import random

import pytest
from conftest import tiny_config

from dvpmvs_torch.utils import profiling
from dvpmvs_torch.utils.profiling import Count, Record, Span
from mvsbench import cells, measure, program_spans, run, trace
from mvsbench.cells import metric_reader

STAGE_METRICS = tuple(program_spans.STAGES)
IDLE_METRICS = STAGE_METRICS + ("runner.unspanned_idle_ms_per_pass",)
COUNT_METRICS = ("weak.pixels_per_pass", "weak.reliable_share")
VP = profiling.VIEW_PASS


def _op(a, b):
    return trace.DeviceOp("k", a, b, "kernel", ())


def _trace_record(ops, lo, hi, n_passes):
    """A TraceRecord as ``trace.read_events`` makes it, with the harness's
    window [lo, hi)."""
    inside = [(max(a, lo), min(b, hi)) for a, b in ops if b > lo and a < hi]
    return trace.TraceRecord(
        n_passes=n_passes, view_pass_s=[], run_pass_s=[],
        device=[_op(a, b) for a, b in ops], calls=[], program_kernels=(),
        window_s=(hi - lo) * 1e-9, busy_s=measure.union_length(inside) * 1e-9,
        idle_by_span={})


def _spans(*rows):
    """Spans from (name, start, end, parent, view pass) rows."""
    return tuple(Span(*r) for r in rows)


# one view pass [0, 100): prepare, the engine pass with setup, propagate
# and post inside, finish; the device busy at [10, 15), [30, 35), [50, 70),
# [85, 90); the harness's window [-5, 105)
PASS = _spans(
    (VP, 0, 100, None, 0),
    ("runner/prepare", 2, 20, 0, 0),
    ("engine/pass", 25, 80, 0, 0),
    ("engine/setup", 26, 40, 2, 0),
    ("engine/propagate", 45, 60, 2, 0),
    ("engine/post", 65, 78, 2, 0),
    ("runner/finish", 82, 98, 0, 0))
OPS = [(10, 15), (30, 35), (50, 70), (85, 90)]


def test_self_time_and_exact_overlap():
    own = program_spans.self_intervals(PASS)
    assert own[VP] == [(0, 2), (20, 25), (80, 82), (98, 100)]
    assert own["engine/pass"] == [(25, 26), (40, 45), (60, 65), (78, 80)]
    assert own["engine/setup"] == [(26, 40)]
    rec = _trace_record(OPS, -5, 105, 1)
    idle = program_spans.idle_by_stage(rec, Record(PASS, ()))
    # gaps in [0, 100): [0, 10), [15, 30), [35, 50), [70, 85), [90, 100)
    assert idle == {VP: 2 + 5 + 2 + 2, "runner/prepare": 8 + 5,
                    "engine/pass": 1 + 5 + 2, "engine/setup": 4 + 5,
                    "engine/propagate": 5, "engine/post": 8,
                    "runner/finish": 3 + 8}
    prog = Record(PASS, ())
    assert program_spans.stage_idle_ms(
        rec, "engine.setup_idle_ms_per_pass", prog) == pytest.approx(9e-6)
    # 110 - 35 = 75 ns idle in the harness's window, 10 of it before and
    # after the program's view pass: the rest is the view pass's, the
    # engine pass's and finish's 11 + 8 + 11 and those 10
    assert program_spans.unspanned_idle_ms(rec, prog) == pytest.approx(
        (75 - 13 - 9 - 5 - 8) * 1e-6)
    assert 75 - 13 - 9 - 5 - 8 == 11 + 8 + 11 + 10


def _random_record(rng, n_passes):
    """Properly nested random spans of ``n_passes`` view passes with the
    runner's and engine's stages (the weak ones in some passes)."""
    rows, t = [], 0
    for vp in range(n_passes):
        t += rng.randint(1, 50)
        root = len(rows)
        rows.append([VP, t, None, None, vp])
        for name in ("runner/prepare", "runner/priors", "engine/pass",
                     "runner/finish"):
            t += rng.randint(0, 20)
            me = len(rows)
            rows.append([name, t, None, root, vp])
            if name == "engine/pass":
                kids = ["engine/setup", "weak/anchors"] + [
                    "engine/propagate", "engine/propagate", "weak/fit",
                    "weak/propagate", "weak/propagate"] * 2 + ["engine/post"]
                for kid in kids:
                    if kid.startswith("weak/") and vp % 2:
                        continue
                    t += rng.randint(0, 10)
                    d = rng.randint(0, 80)
                    rows.append([kid, t, t + d, me, vp])
                    t += d
            t += rng.randint(0, 40)
            rows[me][2] = t
        t += rng.randint(0, 10)
        rows[root][2] = t
    return _spans(*rows), t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stages_and_the_rest_add_up_to_the_idle_time(seed):
    rng = random.Random(seed)
    spans, end = _random_record(rng, 3)
    ops, t = [], -30
    while t < end + 30:
        a = t + rng.randint(0, 25)
        b = a + rng.randint(1, 25)
        ops.append((a, b))
        t = b - rng.randint(0, 10)
    lo, hi = -20, end + 20
    rec = _trace_record(ops, lo, hi, 3)
    prog = Record(spans, ())
    idle_share = metric_reader("device.idle_share")(rec)
    got = [program_spans.stage_idle_ms(rec, m, prog) for m in STAGE_METRICS]
    got.append(program_spans.unspanned_idle_ms(rec, prog))
    assert all(x is not None and x >= 0 for x in got)
    want = idle_share * rec.window_s * 1e3 / rec.n_passes
    assert sum(got) == pytest.approx(want, rel=1e-9, abs=1e-15)
    # each stage against a stab at every nanosecond: idle, in the pass
    # window, and innermost in a span of the stage
    busy = set()
    for a, b in ops:
        busy.update(range(a, b))
    plo, phi = spans[0].start_ns, max(s.end_ns for s in spans)
    for m, x in zip(STAGE_METRICS, got):
        names = program_spans.STAGES[m]
        n = 0
        for ns in range(plo, phi):
            # the innermost: the latest start, a child after its parent
            inner = [(s.start_ns, i) for i, s in enumerate(spans)
                     if s.start_ns <= ns < s.end_ns]
            if (ns not in busy and inner
                    and spans[max(inner)[1]].name in names):
                n += 1
        assert x == pytest.approx(n * 1e-6 / 3, abs=1e-15)


def test_counters_a_pass_and_the_share():
    counts = (Count("weak.pixels", 300.0, 0),
              Count("weak.reliable", 240.0, 0),
              Count("weak.pixels", 100.0, 1),
              Count("weak.reliable", 20.0, 1))
    spans = _spans((VP, 0, 10, None, 0), (VP, 20, 30, None, 1))
    rec = _trace_record([], -5, 35, 2)
    prog = Record(spans, counts)
    assert program_spans.count_per_pass(rec, "weak.pixels", prog) == 200.0
    assert program_spans.share(rec, "weak.reliable", "weak.pixels",
                               prog) == pytest.approx(0.65)
    assert program_spans.count_per_pass(rec, "weak.other", prog) is None


@pytest.mark.parametrize("prog", ["no recorded()", "empty", "other passes"])
def test_nothing_to_read_gives_none(prog, monkeypatch):
    rec = _trace_record(OPS, -5, 105, 1)
    if prog == "no recorded()":
        monkeypatch.delattr(profiling, "recorded")
    else:
        spans = () if prog == "empty" else PASS + _spans(
            (VP, 200, 300, None, 1))
        monkeypatch.setattr(profiling, "recorded",
                            lambda: Record(spans, ()))
    for m in IDLE_METRICS + COUNT_METRICS:
        assert metric_reader(m)(rec) is None


def test_a_pass_without_a_stage_reads_none_for_it(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: Record(PASS, ()))
    rec = _trace_record(OPS, -5, 105, 1)
    assert metric_reader("weak.idle_ms_per_pass")(rec) is None
    assert metric_reader("weak.pixels_per_pass")(rec) is None
    assert metric_reader("runner.priors_idle_ms_per_pass")(rec) is None
    assert metric_reader("engine.setup_idle_ms_per_pass")(rec) == \
        pytest.approx(9e-6)


def test_a_tiny_traced_run_reads_every_metric(torch_cpu):
    """A REFINE_INIT of round 1 on the CPU (3 views at 96 x 128): every
    new metric reads a number, and the idle ones add up."""
    names = ("device.idle_share",) + IDLE_METRICS + COUNT_METRICS
    traffic = {"round": 1, "setup": [[0, 0]], "window": [0],
               "trace_passes": 1}
    cell = cells.Cell("tiny.r1-init", 1, tiny_config(views=3), traffic,
                      [{"name": "view_passes_per_s", "unit": "view-passes/s"},
                       {"name": "setup_s", "unit": "s"}],
                      [{"name": n, "unit": "u"} for n in names])
    import time

    import torch
    line = run.run_cell(torch_cpu, cell, 7, 0.0, True,
                        run.Card(torch_cpu, torch.device("cpu")),
                        time.perf_counter())
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == set(names)
    dev = line["device"]
    whole = (dev["window_s"] - dev["busy_s"]) * 1e3 / line["attempted"]
    assert sum(got[m] for m in IDLE_METRICS) == pytest.approx(whole,
                                                              rel=1e-9)
    assert got["weak.pixels_per_pass"] >= 0
