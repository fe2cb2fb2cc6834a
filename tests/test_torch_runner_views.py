"""The scene runner's cache of scaled views (``SceneRunner._scaled_view``):
each (image, scale) is resized once and then served from the cache, with
the same bits as a runner that computes every view anew (today's float64
resize, cast by ``run_pass``); one scale is kept at a time; a CPU
``run_pass`` writes nothing into a cached image; and the counters
``runner.views`` and ``runner.view_hits`` count the requests while a
profiler records.

The scene: 11 views of ``make_scene`` at 32x48, each with the other 10 as
sources, as the benchmark's scenes have; two passes of view 0 (FIRST_INIT,
then a geometric REFINE_ITER), one iteration, the fused backend (its
kernels' plain versions), on the CPU.  Imports nothing of JAX.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvpmvs_torch.config import PMStatic, SceneConfig, round_pass_params
from dvpmvs_torch.geometry import camera as t_camera
from dvpmvs_torch.io.scene import Problem, Scene
from dvpmvs_torch.priors.edges import _resize_linear
from dvpmvs_torch.rng import Rooted, TorchDraws, fold_in
from dvpmvs_torch.sched import runner as t_runner
from dvpmvs_torch.utils import profiling
from dvpmvs_torch.utils.synthetic import make_scene

H, W, NV = 32, 48, 11
FIELDS = ("depth", "normal_world", "cost", "weak", "sel_views",
          "view_weights", "radius")
STATE = ("depth", "normal_world", "weak", "sel_views", "radius")


class Recomputing(t_runner.SceneRunner):
    """The runner as it was before the cache: every request resizes the
    image in float64 (``run_pass`` casts it to float32) and scales the
    camera anew."""

    def _scaled_view(self, image_id, scale_size):
        img = self.scene.images[image_id]
        h, w = img.shape
        nh, nw = round(h / scale_size), round(w / scale_size)
        simg = _resize_linear(img.astype(np.float32), (nh, nw))
        cam = t_camera.scale_camera(self.scene.cameras[image_id], nw / w,
                                    nh / h)
        return simg, cam


class Cleared(t_runner.SceneRunner):
    """The caching runner with its cache emptied before every request."""

    def _scaled_view(self, image_id, scale_size):
        self.view_cache.clear()
        return super()._scaled_view(image_id, scale_size)


def _scene():
    sc = make_scene(num_views=NV, height=H, width=W, seed=4, noise=1.0)
    views = list(range(NV))
    problems = [Problem(index=v, ref_image_id=v,
                        src_image_ids=[u for u in views if u != v],
                        dense_folder=None, result_folder=None)
                for v in views]
    return Scene(dense_folder=None, image_ids=views,
                 images={v: sc.images[v] for v in views}, colors={},
                 cameras={v: sc.cameras[v] for v in views},
                 problems=problems)


BASE = PMStatic(max_iterations=1, use_edge=False, use_label=False,
                use_radius=False, cost_backend="fused")


def _runner(cls=t_runner.SceneRunner):
    return cls(_scene(), SceneConfig(), base_static=BASE, verbose=False,
               device="cpu", draws=TorchDraws(5, device="cpu"))


def _pass(runner, pass_idx, scale_size):
    """View 0's pass ``pass_idx`` of round 0 at 1/``scale_size``."""
    static, dyn = round_pass_params(0, 2, pass_idx, BASE, 0.0, 1.0)
    runner.run_view_pass(runner.scene.problems[0], static, dyn, scale_size,
                         Rooted(runner.draws, fold_in(fold_in((), pass_idx),
                                                      0)))


def _two_passes(runner, scale_size, monkeypatch, on_pass=None):
    """The two passes: their ``run_pass`` outputs as numpy arrays and the
    view's state after each."""
    outs, states = [], []
    run_pass = t_runner.run_pass

    def kept(*args, **kwargs):
        out = run_pass(*args, **kwargs)
        outs.append({f: getattr(out, f).numpy().copy() for f in FIELDS})
        return out

    monkeypatch.setattr(t_runner, "run_pass", kept)
    for p in (0, 1):
        _pass(runner, p, scale_size)
        states.append(runner.state[0])
        if on_pass is not None:
            on_pass(p)
    return outs, states


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("reference", [Cleared, Recomputing],
                         ids=["cleared", "recomputing"])
@pytest.mark.parametrize("scale_size", [1, 2])
def test_cached_views_give_the_same_bits(scale_size, reference,
                                         monkeypatch):
    got = _two_passes(_runner(), scale_size, monkeypatch)
    want = _two_passes(_runner(reference), scale_size, monkeypatch)
    for out, ref in zip(got[0], want[0]):
        for f in FIELDS:
            np.testing.assert_array_equal(out[f], ref[f], err_msg=f)
    for st, ref in zip(got[1], want[1]):
        for f in STATE:
            np.testing.assert_array_equal(getattr(st, f), getattr(ref, f),
                                          err_msg=f)


@pytest.mark.parametrize("scale_size", [1, 2])
def test_each_view_is_scaled_once_a_scale(scale_size, monkeypatch):
    """The first pass computes all 11 views (a resize each but at full
    size, where the image is taken as it is), the second none."""
    calls = {"resize": 0, "camera": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(t_runner, "_resize_linear",
                        counted("resize", t_runner._resize_linear))
    monkeypatch.setattr(t_runner, "scale_camera",
                        counted("camera", t_runner.scale_camera))
    seen = []
    runner = _runner()
    _two_passes(runner, scale_size, monkeypatch,
                on_pass=lambda p: seen.append(dict(calls)))
    first = NV if scale_size > 1 else 0
    assert seen == [{"resize": first, "camera": NV},
                    {"resize": first, "camera": NV}]
    assert sorted(runner.view_cache) == [(v, scale_size) for v in range(NV)]
    img, cam = runner.view_cache[(0, scale_size)]
    assert img.dtype == np.float32
    assert img.shape == (H // scale_size, W // scale_size)


@pytest.mark.parametrize("scale_size", [1, 2])
def test_a_new_scale_drops_the_other_scales_views(scale_size):
    runner = _runner()
    for v in range(NV):
        runner._scaled_view(v, scale_size)
    other = 3 - scale_size
    img, _ = runner._scaled_view(4, other)
    assert list(runner.view_cache) == [(4, other)]
    assert img.shape == (H // other, W // other)
    again = runner._scaled_view(4, other)
    assert again[0] is img


@pytest.mark.parametrize("scale_size", [1, 2])
def test_a_cpu_pass_writes_nothing_into_a_cached_view(scale_size,
                                                      monkeypatch):
    """The reference image reaches ``run_pass`` as the cached array itself
    (shared, on the CPU, by the tensor ``run_pass`` makes of it); after
    two passes every cached image holds the bytes it was made with."""
    runner = _runner()
    shared = []
    run_pass = t_runner.run_pass

    def check(ref_img, *args, **kwargs):
        shared.append(torch.as_tensor(ref_img, dtype=torch.float32)
                      .data_ptr() == ref_img.ctypes.data)
        return run_pass(ref_img, *args, **kwargs)

    monkeypatch.setattr(t_runner, "run_pass", check)
    _pass(runner, 0, scale_size)
    made = {k: img.copy() for k, (img, _) in runner.view_cache.items()}
    _pass(runner, 1, scale_size)
    assert shared == [True, True]
    assert sorted(made) == sorted(runner.view_cache)
    for k, (img, _) in runner.view_cache.items():
        np.testing.assert_array_equal(img, made[k])
        fresh = Recomputing._scaled_view(runner, *k)[0].astype(np.float32)
        np.testing.assert_array_equal(img, fresh)


def test_the_counters_count_requests_and_hits():
    """While a profiler records: 11 views asked for a pass, none served
    from the cache in the first pass at a scale, all in the next."""
    runner = _runner()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for p in (0, 1):
            _pass(runner, p, 2)
    rec = profiling.recorded()
    by_pass = {}
    for c in rec.counts:
        if c.name.startswith("runner."):
            key = (c.view_pass, c.name)
            by_pass[key] = by_pass.get(key, 0) + c.value
    assert by_pass == {(0, "runner.views"): NV, (1, "runner.views"): NV,
                       (1, "runner.view_hits"): NV}
    # nothing is kept without a profiler
    profiling.reset()
    _pass(runner, 1, 2)
    assert profiling.recorded().counts == ()
