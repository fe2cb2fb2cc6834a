"""The reader of the scene runner's view cache (``runner.view_hit_share``):
the program's counters ``runner.view_hits`` over ``runner.views``, in a
record the scene runner made and in a written one, and nothing where no
view pass ran or the program keeps no such counter."""

import pytest
from torch.profiler import ProfilerActivity, profile

from dvpmvs_torch.geometry.camera import Camera
from dvpmvs_torch.io.scene import Problem, Scene
from dvpmvs_torch.sched.runner import SceneRunner
from dvpmvs_torch.utils import profiling
from dvpmvs_torch.utils.profiling import Count, Record, Span
from mvsbench import trace
from mvsbench.cells import metric_reader
from mvsbench.scene import make_scene

VP = profiling.VIEW_PASS
NAME = "runner.view_hit_share"


def _trace_record(n_passes):
    return trace.TraceRecord(
        n_passes=n_passes, view_pass_s=[], run_pass_s=[], device=[],
        calls=[], program_kernels=(), window_s=1e-6, busy_s=0.0,
        idle_by_span={})


def _runner(views):
    sc = make_scene(num_views=len(views), height=24, width=32, seed=3)
    scene = Scene(dense_folder=None, image_ids=views,
                  images={v: sc.images[v] for v in views}, colors={},
                  cameras={v: Camera.create(**sc.cameras[v]) for v in views},
                  problems=[Problem(index=v, ref_image_id=v,
                                    src_image_ids=[u for u in views
                                                   if u != v],
                                    dense_folder=None, result_folder=None)
                            for v in views])
    return SceneRunner(scene, verbose=False, device="cpu")


def test_the_share_of_a_recorded_run():
    """Three view passes asking for every view at 1/2: the first computes
    them, the next two find them cached."""
    views = [0, 1, 2]
    runner = _runner(views)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.annotate(VP):
                for v in views:
                    runner._scaled_view(v, 2)
    got = metric_reader(NAME)(_trace_record(3))
    assert got == pytest.approx(6 / 9)
    profiling.reset()


@pytest.mark.parametrize("counts,want", [
    ((Count("runner.views", 11.0, 0), Count("runner.view_hits", 11.0, 0),
      Count("runner.views", 11.0, 1), Count("runner.view_hits", 10.0, 1)),
     21 / 22),
    ((Count("runner.views", 11.0, 0), Count("runner.views", 11.0, 1)), 0.0),
    ((), None),
    ((Count("weak.pixels", 5.0, 0),), None)],
    ids=["hits", "no hits", "no counters", "other counters"])
def test_hits_over_views(counts, want, monkeypatch):
    spans = (Span(VP, 0, 10, None, 0), Span(VP, 20, 30, None, 1))
    monkeypatch.setattr(profiling, "recorded",
                        lambda: Record(spans, counts))
    got = metric_reader(NAME)(_trace_record(2))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("spans", [(), (Span(VP, 0, 10, None, 0),)],
                         ids=["no pass", "other passes"])
def test_nothing_where_no_traced_pass_ran(spans, monkeypatch):
    counts = (Count("runner.views", 11.0, 0),
              Count("runner.view_hits", 11.0, 0))
    monkeypatch.setattr(profiling, "recorded",
                        lambda: Record(spans, counts))
    assert metric_reader(NAME)(_trace_record(2)) is None
