"""The port's spans and counters (``dvpmvs_torch/utils/profiling.py``):
nothing recorded without a profiler, the same state with one, every stage
of a view pass nested under it, the record on the profiler's clock, the
weak-pixel counters against the masks, and (on the card) a kernel launched
inside a stage.

Imports nothing of JAX, so the card's test command can run it:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda tests/test_torch_trace.py
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvpmvs_torch.config import (PixelState, PMStatic, SceneConfig,
                                 round_pass_params)
from dvpmvs_torch.engine import patchmatch
from dvpmvs_torch.io.scene import Problem, Scene
from dvpmvs_torch.rng import Rooted, TorchDraws, fold_in
from dvpmvs_torch.sched.runner import SceneRunner
from dvpmvs_torch.utils import profiling
from dvpmvs_torch.utils.synthetic import make_scene

H, W, NV = 48, 64, 3          # round 1's size; round 0 runs at 24 x 32
ITERS = 1
STAGES = {"runner/prepare", "runner/priors", "engine/pass", "engine/setup",
          "engine/propagate", "engine/post", "runner/finish"}
WEAK_STAGES = {"weak/anchors", "weak/fit", "weak/propagate"}
PARENT = {"runner/prepare": profiling.VIEW_PASS,
          "runner/priors": profiling.VIEW_PASS,
          "engine/pass": profiling.VIEW_PASS,
          "runner/finish": profiling.VIEW_PASS,
          "engine/setup": "engine/pass", "engine/propagate": "engine/pass",
          "engine/post": "engine/pass", "weak/anchors": "engine/pass",
          "weak/fit": "engine/pass", "weak/propagate": "engine/pass"}


def _runner(dev):
    """A two-round runner over a small weak-band scene, and its passes:
    FIRST_INIT of round 0 and the APD REFINE_INIT of round 1, view 0."""
    sc = make_scene(num_views=NV, height=H, width=W, seed=6, weak_band=True,
                    noise=1.0)
    views = list(range(NV))
    problems = [Problem(index=v, ref_image_id=v,
                        src_image_ids=[u for u in views if u != v],
                        dense_folder=None, result_folder=None)
                for v in views]
    scene = Scene(dense_folder=None, image_ids=views,
                  images={v: sc.images[v] for v in views}, colors={},
                  cameras={v: sc.cameras[v] for v in views},
                  problems=problems)
    base = PMStatic(max_iterations=ITERS, use_edge=True, use_label=True,
                    use_radius=True, cost_backend="fused")
    draws = TorchDraws(3, device=dev)
    runner = SceneRunner(scene, SceneConfig(max_base_size=W // 2),
                         base_static=base, verbose=False, device=dev,
                         draws=draws)
    assert runner.rounds == 2

    def view_pass(rnd):
        static, dyn = round_pass_params(rnd, runner.rounds, 0, base, 0.0,
                                        1.0)
        runner.run_view_pass(problems[0], static, dyn,
                             2 ** (runner.rounds - 1 - rnd),
                             Rooted(draws, fold_in(fold_in((), rnd), 0)))
        return runner.state[0]

    return view_pass


def _passes(view_pass):
    """The two passes' states; between them a patch is marked weak (round
    0 at this size leaves next to none), as a textureless region of a real
    scene is."""
    first = view_pass(0)
    kept = dataclasses.replace(first)
    first.weak = first.weak.copy()
    first.weak[8:16, 10:22] = int(PixelState.WEAK)
    return [kept, view_pass(1)]


@pytest.fixture(scope="module")
def traced():
    """The two view passes without a profiler, then with one (the weak
    pixels entering ``find_anchors`` counted from its own masks): the
    states, the record and the profiler's host events."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        plain = _passes(_runner(torch.device("cpu")))
        direct = []
        find_anchors = patchmatch.find_anchors

        def counted(weak, *args, **kwargs):
            res = find_anchors(weak, *args, **kwargs)
            wk = weak == PixelState.WEAK
            direct.append((int(wk.sum()), int((wk & res.reliable).sum())))
            return res

        view_pass = _runner(torch.device("cpu"))
        profiling.reset()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(patchmatch, "find_anchors", counted)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                states = _passes(view_pass)
        rec = profiling.recorded()
        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in STAGES | WEAK_STAGES
                  | {profiling.VIEW_PASS}]
    finally:
        torch.set_num_threads(n)
    return dict(plain=plain, states=states, rec=rec, events=events,
                direct=direct)


def test_nothing_is_recorded_without_a_profiler():
    profiling.reset()
    assert not profiling.recording()
    a, b = profiling.annotate("engine/setup"), profiling.annotate("x/y")
    assert a is b                       # one shared no-op context
    with a:
        profiling.count("weak.pixels", torch.ones(()))
    calls = []
    f = profiling.spanned("engine/pass")(lambda x: calls.append(x) or x)
    assert f(3) == 3 and calls == [3]
    rec = profiling.recorded()
    assert rec.spans == () and rec.counts == ()


def test_a_profiler_leaves_the_state_bit_for_bit(traced):
    for got, want in zip(traced["states"], traced["plain"]):
        for field in ("depth", "normal_world", "weak", "sel_views",
                      "radius"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))


def test_every_stage_nests_under_its_view_pass(traced):
    spans = traced["rec"].spans
    vps = [s for s in spans if s.name == profiling.VIEW_PASS]
    assert [s.view_pass for s in vps] == [0, 1]
    assert all(s.parent is None for s in vps)
    for vp, weak in ((0, False), (1, True)):
        mine = [s for s in spans if s.view_pass == vp
                and s.name != profiling.VIEW_PASS]
        names = {s.name for s in mine}
        assert names == STAGES | (WEAK_STAGES if weak else set())
        for s in mine:
            parent = spans[s.parent]
            assert parent.name == PARENT[s.name]
            assert parent.view_pass == vp
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        n = lambda name: sum(s.name == name for s in mine)
        assert n("engine/propagate") == 2 * ITERS
        assert n("weak/propagate") == (2 * ITERS if weak else 0)
        assert n("weak/anchors") == n("weak/fit") // ITERS == int(weak)
        for name in STAGES - {"engine/propagate"}:
            assert n(name) == 1


def test_the_record_is_on_the_profilers_clock(traced):
    """Each recorded span and the profiler's own event of it agree within
    50 us at both ends: the record is stamped inside the range."""
    spans = sorted(traced["rec"].spans, key=lambda s: s.start_ns)
    events = sorted(traced["events"], key=lambda e: e[1])
    assert [s.name for s in spans] == [e[0] for e in events]
    for s, (_, start, end) in zip(spans, events):
        assert 0 <= s.start_ns - start <= 50_000
        assert 0 <= end - s.end_ns <= 50_000


def test_weak_counters_equal_the_masks(traced):
    rec = traced["rec"]
    (pixels, reliable), = traced["direct"]
    assert pixels > 0 and 0 < reliable < pixels
    assert rec.total("weak.pixels") == pixels
    assert rec.total("weak.reliable") == reliable
    assert {c.view_pass for c in rec.counts} == {1}


def test_threads_nest_their_own_spans():
    """Spans opened in two threads at once nest within their own thread;
    ``trace`` starts from an empty record."""
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.annotate(profiling.VIEW_PASS):
            barrier.wait()
            with profiling.annotate(f"t{tag}/stage"):
                barrier.wait()
                profiling.count("n", tag)

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("stale"):
            pass
        profiling.reset()
        threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    rec = profiling.recorded()
    assert sorted(s.name for s in rec.spans) == [
        profiling.VIEW_PASS, profiling.VIEW_PASS, "t1/stage", "t2/stage"]
    for s in rec.spans:
        if s.name != profiling.VIEW_PASS:
            parent = rec.spans[s.parent]
            assert parent.name == profiling.VIEW_PASS
            assert parent.view_pass == s.view_pass
            tag = int(s.name[1])
            assert [c.view_pass for c in rec.counts if c.value == tag] == [
                s.view_pass]
    assert rec.spans[0].view_pass != rec.spans[1].view_pass


@pytest.mark.cuda
def test_a_kernel_launched_in_a_stage_runs_after_its_start():
    """On the card: every device operation launched inside a strong
    half-iteration (``engine/propagate``) starts on the device after the
    span's start and before the view pass's end (which waits for the
    device), on the record's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    view_pass = _runner(dev)
    view_pass(0)
    torch.cuda.synchronize(dev)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        view_pass(0)
        torch.cuda.synchronize(dev)
    rec = profiling.recorded()
    events = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if str(e.device_type()).endswith("CPU")
              and e.name().startswith("cu")}
    device = [e for e in events
              if not str(e.device_type()).endswith("CPU")]
    # no span of the program shows as a device operation
    names = {s.name for s in rec.spans}
    assert not any(e.name() in names for e in device)
    (vp,) = [s for s in rec.spans if s.name == profiling.VIEW_PASS]
    props = [s for s in rec.spans if s.name == "engine/propagate"]
    assert len(props) == 2 * ITERS
    seen = 0
    for s in props:
        for e in device:
            t = launch.get(e.correlation_id())
            if t is not None and s.start_ns <= t <= s.end_ns:
                assert s.start_ns <= e.start_ns() <= e.end_ns() <= vp.end_ns
                seen += 1
    assert seen > 0
