"""The debug outputs against the JAX package on the CPU: the dump writer's
three files (``weak_ncc_cost.bin``, ``neighbour_map.bin``,
``neighbour.bin``), the sweep cost curves that a pass with ``debug_dumps``
returns, and the medium-result images of ``utils/viz.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (JaxDraws, compile_jax, jax_math, np_,
                                t_camera, t_cameras)

from dvpmvs.config import PMDynamic, PMStatic, RunState
from dvpmvs.engine import run_pass as j_run_pass
from dvpmvs.engine.state import PassOutput as JPassOutput
from dvpmvs.geometry import stack_cameras
from dvpmvs.sched.runner import SceneRunner as JSceneRunner
from dvpmvs.utils import viz as j_viz
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch import convert
from dvpmvs_torch.engine import run_pass as t_run_pass
from dvpmvs_torch.engine.state import PassOutput as TPassOutput
from dvpmvs_torch.sched.runner import SceneRunner as TSceneRunner
from dvpmvs_torch.utils import viz as t_viz

_FILES = ("weak_ncc_cost.bin", "neighbour_map.bin", "neighbour.bin")


def _problem(folder):
    return type("P", (), {"result_folder": folder})


def test_dump_writer_bytes_match_jax(tmp_path):
    """Both writers on the same numbers (curves, anchors with a random
    validity): the three files byte for byte."""
    H, W, A, V = 9, 12, 11, 2
    rng = np.random.default_rng(4)
    curve = rng.uniform(0, 2, (61, H, W)).astype(np.float32)
    axy = rng.integers(0, 12, (A, H, W, 2)).astype(np.int32)
    av = rng.uniform(size=(A, H, W)) < 0.3
    base = dict(depth=np.zeros((H, W), np.float32),
                normal_world=np.zeros((H, W, 3), np.float32),
                cost=np.zeros((H, W), np.float32),
                weak=np.zeros((H, W), np.int8),
                sel_views=np.zeros((H, W, V), bool),
                view_weights=np.zeros((H, W, V), np.float32),
                radius=np.zeros((H, W), np.float32))
    j_out = JPassOutput(**{k: jnp.asarray(v) for k, v in base.items()},
                        cost_line=jnp.asarray(curve),
                        anchors_xy=jnp.asarray(axy),
                        anchors_valid=jnp.asarray(av))
    t_out = TPassOutput(**{k: torch.as_tensor(v) for k, v in base.items()},
                        cost_line=torch.as_tensor(curve),
                        anchors_xy=torch.as_tensor(axy),
                        anchors_valid=torch.as_tensor(av))
    JSceneRunner._write_debug_dumps(None, _problem(tmp_path / "j"), j_out)
    TSceneRunner._write_debug_dumps(None, _problem(tmp_path / "t"), t_out)
    for name in _FILES:
        got = (tmp_path / "t" / name).read_bytes()
        assert got == (tmp_path / "j" / name).read_bytes(), name
    assert len((tmp_path / "t" / _FILES[0]).read_bytes()) == \
        12 + 4 * H * W * 61


def test_cost_line_of_a_pass_matches_jax():
    """JAX's ``test_debug_dumps_cost_line_from_pass`` setup (FIRST_INIT,
    24x32, two sources, one iteration, exact backend, ``debug_dumps``): the
    port's pass with JAX's draws and math against JAX's compiled with
    JAX_FAST_COMPILE.  Bounds: curves [61, H, W] within 1e-4 at >= 99 % of
    the entries, and JAX's own check of the curve minimum.  Measured: within
    1e-4 at 0.99985 of the entries."""
    scene = make_scene(num_views=3, height=24, width=32, seed=3)
    static = PMStatic(state=RunState.FIRST_INIT, num_src=2, max_iterations=1,
                      cost_backend="exact", debug_dumps=True)
    dyn = PMDynamic.create(depth_min=float(scene.cameras[0].depth_min),
                           depth_max=float(scene.cameras[0].depth_max))
    key = jax.random.PRNGKey(0)
    args = (jnp.asarray(scene.images[0]), jnp.asarray(scene.images[[1, 2]]),
            scene.cameras[0], stack_cameras([scene.cameras[1],
                                             scene.cameras[2]]))
    fn = lambda *a: j_run_pass(*a, static=static, dyn=dyn, key=key)
    want = np.asarray(compile_jax(fn, *args)(*args).cost_line)
    with jax_math():
        out = t_run_pass(
            scene.images[0], scene.images[[1, 2]],
            t_camera(scene.cameras[0]),
            t_cameras([scene.cameras[1], scene.cameras[2]]),
            convert.static_params(static), convert.dynamic_params(dyn),
            JaxDraws(key), device="cpu")
    got = np_(out.cost_line)
    assert got.shape == want.shape == (61, 24, 32)
    assert out.anchors_xy is None and out.anchors_valid is None
    close = np.abs(got - want) <= 1e-4
    print(f"cost line: within 1e-4 at {close.mean():.5f} of the entries")
    assert close.mean() >= 0.99
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 2.0
    assert (got[:, 8:-8, 8:-8].argmin(axis=0) == 30).mean() > 0.2


@pytest.mark.parametrize("suffix", [".jpg", ".png"])
def test_medium_result_images_match_jax(tmp_path, suffix):
    """depth_color and the four writers on the same maps: the pixels JAX's
    writers produce (a .jpg is PIL's encoding of them, byte for byte)."""
    from PIL import Image
    rng = np.random.default_rng(2)
    H, W = 17, 23
    depth = rng.uniform(0.5, 6.0, (H, W)).astype(np.float32)
    depth[3:6, 4:9] = 0.0
    normal = rng.standard_normal((H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    weak = rng.integers(0, 3, (H, W)).astype(np.int8)
    edge = rng.uniform(size=(H, W)) < 0.2
    np.testing.assert_array_equal(t_viz.depth_color(depth, 1.0, 5.0),
                                  j_viz.depth_color(depth, 1.0, 5.0))
    writes = [("write_depth_viz", (depth, 1.0, 5.0)),
              ("write_normal_viz", (normal,)),
              ("write_weak_viz", (weak,)), ("write_edge_viz", (edge,))]
    for name, a in writes:
        tp, jp = tmp_path / f"t_{name}{suffix}", tmp_path / f"j_{name}{suffix}"
        getattr(t_viz, name)(tp, *a)
        getattr(j_viz, name)(jp, *a)
        if suffix == ".jpg":
            assert tp.read_bytes() == jp.read_bytes(), name
        got = np.asarray(Image.open(tp))
        assert got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, np.asarray(Image.open(jp)))
