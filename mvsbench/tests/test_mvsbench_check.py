"""The comparison that decides ``correct``: a sound run reads correct, the
control (the reference's cost kernels in bfloat16 storage) and each fault
planted under the timed path read not correct, and the result line has the
keys a result line must have."""

import dataclasses
import time

import pytest
import torch

from conftest import tiny_config

from mvsbench import cells, check, control, run
from mvsbench.stages import view_pass

TRAFFIC_R0 = {"round": 0, "setup": [[0, 0]], "window": [0, 1],
              "trace_passes": 2}
SEED = 2 ** 31 + 3


def tiny_cell(traffic=TRAFFIC_R0, **kw):
    return cells.Cell("tiny.r0", 1, tiny_config(views=3, **kw), traffic,
                      [{"name": "view_passes_per_s", "unit": "view-passes/s"},
                       {"name": "setup_s", "unit": "s"}],
                      [{"name": "device.idle_share", "unit": "share"}])


def run_tiny(torch_mod, trace_on=False, cell=None):
    return run.run_cell(torch_mod, cell or tiny_cell(), SEED, 0.0, trace_on,
                        run.Card(torch_mod, torch.device("cpu")),
                        time.perf_counter())


def test_a_sound_run_is_correct_and_its_line_has_the_keys(torch_cpu):
    line = run_tiny(torch_cpu)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 1 and 0.0 <= line["acc2"] <= 1.0
    assert set(line["metrics"]) == {"view_passes_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_a_traced_run_has_busy_window_and_breakdown(torch_cpu):
    line = run_tiny(torch_cpu, trace_on=True)
    assert line["correct"] is True and line["attempted"] == 2
    assert set(line["metrics"]) == {"device.idle_share"}
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    bd = line["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in bd.values())


def _after_set_up(monkeypatch, patch):
    """Apply ``patch`` (given the program's runner module) once set-up is
    done, so the fault lies under the window's passes only."""
    from dvpmvs_torch.sched import runner as runner_mod

    set_up = view_pass.set_up

    def faulty(*a, **kw):
        system = set_up(*a, **kw)
        patch(runner_mod)
        return system
    monkeypatch.setattr(view_pass, "set_up", faulty)
    return runner_mod


def test_fault_state_left_unchanged(torch_cpu, monkeypatch):
    def patch(runner_mod):
        monkeypatch.setattr(runner_mod.SceneRunner, "run_view_pass",
                            lambda self, *a, **kw: None)
    _after_set_up(monkeypatch, patch)
    assert run_tiny(torch_cpu)["correct"] is False


def test_fault_half_of_the_sources_left_out(torch_cpu, monkeypatch):
    def patch(runner_mod):
        real = runner_mod.run_pass

        def half(ref_img, src_imgs, ref_cam, src_cams, **kw):
            h = src_imgs.shape[0] // 2
            src_cams = dataclasses.replace(src_cams, **{
                f.name: getattr(src_cams, f.name)[:h]
                for f in dataclasses.fields(src_cams)})
            for k in ("init_sel_views",):
                if kw.get(k) is not None:
                    kw[k] = kw[k][..., :h]
            if kw.get("src_depths") is not None:
                kw["src_depths"] = kw["src_depths"][:h]
            return real(ref_img, src_imgs[:h], ref_cam, src_cams, **kw)
        monkeypatch.setattr(runner_mod, "run_pass", half)
    _after_set_up(monkeypatch, patch)
    assert run_tiny(torch_cpu)["correct"] is False


def test_fault_one_answer_altered(torch_cpu, monkeypatch):
    def patch(runner_mod):
        real = runner_mod.run_pass

        def altered(*a, **kw):
            out = real(*a, **kw)
            depth = out.depth.clone()
            H, W = depth.shape
            depth[H // 2, W // 2] *= 1.05
            return dataclasses.replace(out, depth=depth)
        monkeypatch.setattr(runner_mod, "run_pass", altered)
    _after_set_up(monkeypatch, patch)
    line = run_tiny(torch_cpu)
    assert line["correct"] is False
    assert line["checks"]["init.mismatch_px"]["value"] == 1.0


def test_the_control_is_not_correct(torch_cpu):
    """The reference with its cost kernels in bfloat16 storage, in the
    program's place, fails the comparison on every pass kind."""
    cell = tiny_cell()
    got = control.readings(torch_cpu, cell, SEED,
                           run.Card(torch_cpu, torch.device("cpu")))
    for kind, nums in got["program"].items():
        assert check.verdict(nums), (kind, nums)
    for kind, nums in got["control"].items():
        assert not check.verdict(nums), (kind, nums)
        assert nums["depth_off_share"] > check.LIMITS["depth_off_share"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """A short run of the smallest cell on the card, from the checkout's
    BENCHMARK.json."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pathlib import Path

    from conftest import REPO

    cell = cells.load_cell(REPO, "tnt.r0")
    line = run.run_cell(torch, cell, SEED, 2.0, False,
                        run.Card(torch, torch.device("cuda", 0)),
                        time.perf_counter())
    assert line["correct"] is True
