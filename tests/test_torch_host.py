"""The port's CPU results do not move with MKL's dispatch.

MKL picks a code path by CPU vendor and instruction set; ``MKL_CBWR=
COMPATIBLE`` pins it to one that every x86 host runs.  A small REFINE_ITER
APD pass of the port alone (no JAX; 32x32, ``make_scene`` inputs, seeded
``TorchDraws``, the fused backend's plain versions) runs in two
subprocesses, one under ``MKL_CBWR=COMPATIBLE`` and one under the default
dispatch, and its outputs must be equal bit for bit.  A BLAS call on the
pass's path (a ``torch.einsum`` or ``@`` on CPU float32 tensors) rounds
differently on hosts where MKL's default path is not the compatible one,
such as an Intel host with AVX-512.

Run as a script, the file runs the pass once and saves its outputs:
``python tests/test_torch_host.py <out.npz>``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_FIELDS = ("depth", "normal_world", "cost", "weak", "sel_views",
           "view_weights", "radius")


def run_slice(out_path: str) -> None:
    """One REFINE_ITER pass of round 1 (APD, geometric consistency) from a
    perturbed ground truth; saves the PassOutput fields."""
    import torch

    from dvpmvs_torch.config import PMStatic, PixelState, round_pass_params
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.geometry import stack_cameras
    from dvpmvs_torch.rng import TorchDraws
    from dvpmvs_torch.utils.synthetic import make_scene

    torch.set_num_threads(2)
    H = W = 32
    V = 3
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=2)
    ref = scene.cameras[0]
    base = PMStatic(num_src=V, max_iterations=1, cost_backend="fused",
                    use_label=False)
    st, dyn = round_pass_params(1, 2, 1, base, float(ref.depth_min),
                                float(ref.depth_max))
    rng = np.random.default_rng(0)
    depth = scene.gt_depth[0] * (1 + 0.05 * rng.standard_normal((H, W)))
    normal = scene.gt_normal[0] @ np.asarray(ref.R)
    plane = np.concatenate([normal, depth[..., None]], -1).astype(np.float32)
    weak = np.where(rng.uniform(size=(H, W)) < 0.4, PixelState.WEAK,
                    PixelState.STRONG).astype(np.int8)
    out = run_pass(
        scene.images[0], scene.images[1:], ref,
        stack_cameras(scene.cameras[1:]), st, dyn,
        TorchDraws(3, device="cpu"), init_plane_world=plane,
        init_sel_views=rng.uniform(size=(H, W, V)) < 0.8, init_weak=weak,
        src_depths=np.stack(scene.gt_depth[1:]).astype(np.float32),
        device="cpu")
    np.savez(out_path, **{f: getattr(out, f).numpy() for f in _FIELDS})


def _child(out_path: Path, cbwr):
    env = dict(os.environ, PYTHONPATH=str(_ROOT), OMP_NUM_THREADS="2")
    env.pop("MKL_CBWR", None)
    if cbwr is not None:
        env["MKL_CBWR"] = cbwr
    subprocess.run([sys.executable, __file__, str(out_path)], env=env,
                   cwd=str(_ROOT), check=True, timeout=600)
    return np.load(out_path)


def test_port_results_do_not_depend_on_mkl_dispatch(tmp_path):
    a = _child(tmp_path / "compatible.npz", "COMPATIBLE")
    b = _child(tmp_path / "default.npz", None)
    assert (a["depth"] > 0).mean() > 0.9
    for f in _FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


if __name__ == "__main__":
    sys.path.insert(0, str(_ROOT))
    run_slice(sys.argv[1])
