"""The benchmark's arithmetic: the window's rate and tail, the idle share
of a synthetic trace, the roofline counts against chip_smoke.py's."""

import pytest

from mvsbench import measure, trace
from mvsbench.cells import metric_reader
from mvsbench.run import Window


def test_rate_counts_whole_passes_over_the_window():
    win = Window([0.5, 0.25, 0.25, 1.0], window_s=2.5, setup_s=7.0)
    assert metric_reader("view_passes_per_s")(win) == pytest.approx(1.6)
    assert metric_reader("setup_s")(win) == 7.0


def test_the_tail_is_the_nearest_rank():
    walls = [float(i) for i in range(1, 101)]           # 1 .. 100
    assert measure.percentile(walls, 90) == 90.0
    assert measure.percentile(walls[:10], 90) == 9.0
    assert measure.percentile([3.0, 1.0, 2.0], 90) == 3.0
    win = Window(walls[::-1], window_s=sum(walls), setup_s=1.0)
    assert metric_reader("view_pass_p85_s")(win) == 85.0
    # ten passes beyond it from 67 in the window on
    assert sum(w > measure.percentile(walls[:67], 85)
               for w in walls[:67]) == 10


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert measure.union_length(iv) == 5.0
    assert measure.idle_gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]


class _Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, device, start, end, corr=0, linked=0):
        self._n, self._d, self._s, self._e = name, device, start, end
        self._c, self._l = corr, linked

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def test_idle_share_and_attribution_on_a_synthetic_trace():
    P = trace.PREFIX
    ev = [
        _Ev(P + "runner/run_view_pass", "CPU", 0, 100, corr=1),
        _Ev(P + "engine/run_pass", "CPU", 10, 90, corr=2),
        _Ev(P + "kernels/fused_ncc_costs#0", "CPU", 20, 30, corr=3),
        _Ev("aten::add", "CPU", 40, 45, corr=4),
        _Ev("cudaLaunchKernel", "CPU", 21, 22, corr=4, linked=3),
        _Ev(P + "weak/find_anchors", "CPU", 50, 60, corr=5),
        _Ev("aten::mul", "CPU", 52, 53, corr=6),
        # device: K1 launched inside the kernel span (its runtime call has
        # the same correlation id; aten::add's id of 4 is another count),
        # glue by aten::add, one weak copy; the profiler's own range
        # mirrored on the device
        _Ev("ncc_fused_kernel(float const*)", "CUDA", 25, 35, corr=4,
            linked=3),
        _Ev("elementwise_kernel", "CUDA", 41, 46, linked=4),
        _Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 54, 56, linked=6),
        _Ev(P + "kernels/fused_ncc_costs#0", "CUDA", 25, 35, linked=3),
    ]
    call = trace.KernelCall("fused_ncc_costs", P + "kernels/fused_ncc_costs#0",
                            ops=0.0, nbytes=0.0, bound_s=2e-9,
                            bound_by="operations")
    rec = trace.read_events(ev, [call], [0.08], ("ncc_fused_kernel",))
    assert rec.n_passes == 1 and rec.window_s == pytest.approx(100e-9)
    assert len(rec.device) == 3
    assert rec.launch_times == {"runtime": 1, "operation": 2,
                                "own start": 0}
    assert rec.busy_s == pytest.approx(17e-9)
    assert metric_reader("device.idle_share")(rec) == pytest.approx(0.83)
    assert call.device_s == pytest.approx(10e-9)
    assert metric_reader("cost_kernels_roofline")(rec) == pytest.approx(20.0)
    assert metric_reader("kernels.device_ms_per_pass")(rec) == \
        pytest.approx(10e-6)
    assert metric_reader("engine.glue_ms_per_pass")(rec) == \
        pytest.approx(7e-6)
    assert metric_reader("weak.device_ms_per_pass")(rec) == \
        pytest.approx(2e-6)
    assert metric_reader("engine.device_ops_per_pass")(rec) == 3
    assert metric_reader("runner.host_ms_per_pass")(rec) == \
        pytest.approx(1e3 * (100e-9 - 0.08))
    kinds = sorted(op.kind for op in rec.device)
    assert kinds == ["kernel", "kernel", "memcpy"]
    bd = trace.breakdown(rec)
    assert bd["device_ops"][0] == ["ncc_fused_kernel(float const*)",
                                   pytest.approx(10e-9)]
    # gaps (0, 25), (35, 41), (56, 100) lie in run_pass, (46, 54) in the
    # anchor search by their midpoints
    idle = dict(bd["idle_gaps"])
    assert idle == {"engine/run_pass": pytest.approx(75e-9),
                    "weak/find_anchors": pytest.approx(8e-9)}


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = trace.TraceRecord(1, [0.1], [0.05], [], [], (), 0.1, 0.01, {})
    assert metric_reader("weak.device_ms_per_pass")(rec) is None
    assert metric_reader("cost_kernels_roofline")(rec) is None


# The bounds of PERF.md's kernel table (608x800, V=10; chip_smoke.py's
# kernel phase, commit 3b5ba0b), in ms, with what bounds them.
H, W, V = 608, 800, 10
P_PK = H * ((W + 1) // 2)


@pytest.mark.parametrize("work, ms, by", [
    (measure.k1_work(17, H, 400, V, H, W, False), 0.703, "operations"),
    (measure.k1_work(6, H, 400, V, H, W, False), 0.248, "operations"),
    (measure.k1_work(8, H, W, V, H, W, True), 0.662, "operations"),
    (measure.k2_work(61, H, W, V), 1.404, "operations"),
    (measure.k2_work(11, H, W, V), 0.253, "operations"),
    (measure.k3_work(61, H, W, V, H, W, True), 0.248, "operations"),
    (measure.k3_work(8, H, W, V, H, W, False), 0.0569, "bytes"),
    (measure.k3_work(10, H, 400, V, H, W, False), 0.0378, "bytes"),
    (measure.k3_work(6, H, 400, V, H, W, False), 0.0250, "bytes"),
    (measure.k4_work(10, 121_600, V, 11, H, W, 0, 722_520, 0), 0.0895,
     "operations"),
    (measure.warp_ncc_work(17, H, W, V, H), 0.347, "operations"),
    (measure.warp_ncc_work(1, H, W, V, H), 0.0575, "bytes"),
])
def test_roofline_counts_match_chip_smoke(work, ms, by):
    t, what = measure.bound_s(*work)
    assert what == by
    assert t * 1e3 == pytest.approx(ms, rel=2e-3)
