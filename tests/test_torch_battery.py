"""The port's "fused" backend on the CPU (each kernel replaced by its plain
version) over the four-scene accuracy battery of tests/test_engine.py:
FIRST_INIT from random initialization, 96x128, V=4, three iterations, the
production draw source.  It must meet the same floors as the JAX engine.
"""

import numpy as np
import pytest

import test_torch_support  # noqa: F401  (caps torch's threads)
from test_engine import FLOORS, H_B, NV, SCENES, W_B

from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch import convert
from dvpmvs_torch.config import PMDynamic, PMStatic, RunState
from dvpmvs_torch.engine import run_pass
from dvpmvs_torch.geometry import stack_cameras
from dvpmvs_torch.kernels import _build
from dvpmvs_torch.rng import TorchDraws


@pytest.mark.parametrize("name", list(SCENES))
def test_fused_backend_meets_engine_floors(name):
    scene = make_scene(num_views=NV, height=H_B, width=W_B, **SCENES[name])
    cams = [convert.camera(c, device="cpu") for c in scene.cameras]
    ref = cams[0]
    _build.reset_launches()
    out = run_pass(
        scene.images[0], scene.images[1:], ref, stack_cameras(cams[1:]),
        PMStatic(state=RunState.FIRST_INIT, num_src=NV - 1,
                 max_iterations=3, cost_backend="fused"),
        PMDynamic.create(depth_min=float(ref.depth_min),
                         depth_max=float(ref.depth_max)),
        TorchDraws(0, device="cpu"), device="cpu")
    # on the CPU every kernel runs as its plain version: nothing launches
    assert all(n == 0 for n in _build.LAUNCHES.values())
    m = 8
    d = out.depth.numpy()[m:-m, m:-m]
    gt = scene.gt_depth[0][m:-m, m:-m]
    valid = d > 0
    acc = float(((np.abs(d - gt) / np.maximum(gt, 1e-6) < 0.02)
                 & valid).mean())
    comp = float(valid.mean())
    print(f"{name}: acc2 {acc:.4f} completeness {comp:.4f}")
    acc_floor, comp_floor = FLOORS[name]
    assert acc >= acc_floor, (name, acc)
    assert comp >= comp_floor, (name, comp)
