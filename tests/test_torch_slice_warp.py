"""The round-0 slice pixel by pixel with the "warp" cost backend,
FIRST_INIT from random planes: 48x64, V=4, one iteration, Canny edges,
JAX's "warp" backend against the port's on the CPU, from the same inputs and
the same random numbers.

In warp mode a pixel's cost reads the warped field at its 36 taps, each
warped by the plane of the tap's own pixel, so one neighbour's different
plane changes every cost within the window radius.  From random planes that
coupling spreads every last-bit difference: the port's transcendentals
(cos, sin, rsqrt, exp, and PyTorch's vectorized CPU sqrt) round
differently from XLA's in the last bit (one strong half-iteration from one
state: 99.4 % of the planes within 1e-4, the second test here), and after
one iteration the depth maps agree only by share.  JAX against itself, the pass compiled at XLA's
default and at its cheapest optimisation level, agrees within 1e-4 at
45.8 % of the pixels and within 1 % at 61.5 %, weak classes at 99.06 %.
The port agrees with JAX better than that; the bounds hold it there.
(From converged planes the warp backend is well conditioned:
test_torch_slice_warp_refine.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_support import (SLICE_H, SLICE_V, SLICE_W, JaxDraws, acc2,
                                agreement, compile_jax, jax_pass, np_,
                                port_pass, slice_problem, t_camera, t_cameras)

from dvpmvs.config import RunState
from dvpmvs.engine import patchmatch as j_pm
from dvpmvs.engine.state import PMState as JState
from dvpmvs.geometry import stack_cameras
from dvpmvs.geometry.transforms import dist_to_origin
from dvpmvs.kernels import ncc as j_ncc
from dvpmvs.kernels.weak import edge_ray_distance as j_erd

from dvpmvs_torch import convert
from dvpmvs_torch.engine import patchmatch as t_pm
from dvpmvs_torch.engine.state import PMState as TState
from dvpmvs_torch.kernels import ncc as t_ncc
from dvpmvs_torch.kernels.weak import edge_ray_distance as t_erd
from dvpmvs_torch.rng import fold_in, split


def test_first_init_warp_slice_matches_jax():
    """Measured: depth within 1e-4 at 61.1 % of the pixels and within 1 %
    at 74.3 %; weak classes equal at 99.2 %, selected views at 99.0 %;
    acc2 0.130 (JAX 0.117: warp FIRST_INIT converges slowly from random
    planes, as dvpmvs/config.py warns)."""
    scene, edge, st, dyn = slice_problem(0, "warp")
    assert st.state == RunState.FIRST_INIT and st.cost_backend == "warp"
    want = jax_pass(scene, edge, st, dyn)
    got = port_pass(scene, edge, st, dyn)
    s = agreement(got, want)
    gt = scene.gt_depth[0]
    print(f"warp FIRST_INIT slice, port vs JAX: {s}; acc2 port "
          f"{acc2(np_(got.depth), gt):.4f} JAX {acc2(want.depth, gt):.4f}")
    assert tuple(got.depth.shape) == (SLICE_H, SLICE_W)
    assert s["weak"] >= 0.98 and s["sel"] >= 0.98, s
    assert s["depth_1pct"] >= 0.70, s


def test_strong_half_iteration_warp_matches_jax():
    """One strong half-iteration (color 0) of the warp FIRST_INIT from the
    same random planes, initial costs, contexts and draws: JAX's
    ``_propagate_color_strong`` against the port's, before any difference
    can spread.  Bounds: initial costs within 1e-4 everywhere, planes
    within 1e-4 at >= 99 % of the pixels.  Measured: initial costs and
    selected views equal within 1e-4 everywhere; planes within 1e-4 at
    99.41 % (JAX jitted against JAX op by op: 100 %; the rest is PyTorch's
    vectorized CPU sqrt, one ulp off at a few candidate costs)."""
    scene, edge, st, dyn = slice_problem(0, "warp")
    H, W = SLICE_H, SLICE_W
    ref, src = scene.cameras[0], stack_cameras(scene.cameras[1:])
    ref_t, src_t = t_camera(ref), t_cameras(scene.cameras[1:])
    cj = j_ncc.build_cost_context(
        jnp.asarray(scene.images[0]), jnp.asarray(scene.images[1:]), ref,
        src, dyn.sigma_spatial, dyn.sigma_color, backend="warp")
    fields = ("M", "b", "w_taps", "wref_taps", "sum_w", "sum_wref",
              "sum_wref2", "radius", "rx", "ry", "src_wh")
    ct = t_ncc.build_cost_context(
        torch.as_tensor(scene.images[0]), torch.as_tensor(scene.images[1:]),
        ref_t, src_t, dyn.sigma_spatial, dyn.sigma_color,
        backend="warp").replace(
            **{f: torch.as_tensor(np.array(getattr(cj, f))) for f in fields})

    rng = np.random.default_rng(0)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n[..., 2] = -np.abs(n[..., 2]) - 0.5
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(float(ref.depth_min), float(ref.depth_max),
                    (H, W)).astype(np.float32)
    w = np.asarray(dist_to_origin(jnp.asarray(n), jnp.asarray(xs),
                                  jnp.asarray(ys), jnp.asarray(d), ref))
    plane = np.concatenate([n, w[..., None]], -1).astype(np.float32)
    j_cost, j_sel = j_pm._initial_cost_first(cj, jnp.asarray(plane),
                                             st.top_k)
    t_cost, t_sel = t_pm._initial_cost_first(ct, torch.as_tensor(plane),
                                             st.top_k)
    assert np.abs(np_(t_cost) - np.asarray(j_cost)).max() <= 1e-4
    np.testing.assert_array_equal(np_(t_sel), np.asarray(j_sel))

    xs_t, ys_t = torch.as_tensor(xs), torch.as_tensor(ys)
    rx = (xs_t - ref_t.cx) / ref_t.fx
    ry = (ys_t - ref_t.cy) / ref_t.fy
    ray = t_pm._ray(rx, ry)
    parity = (xs_t.to(torch.int32) + ys_t.to(torch.int32)) % 2
    edge_t = torch.as_tensor(edge)
    state_t = TState(plane=torch.as_tensor(plane), cost=t_cost,
                     sel_views=t_sel,
                     view_weights=torch.zeros((H, W, SLICE_V)),
                     weak=torch.ones((H, W), dtype=torch.int8),
                     radius=torch.zeros((H, W)))
    draws = JaxDraws(jax.random.PRNGKey(0))
    path_it = fold_in(split((), 3, 2), 0)
    grids = tuple(jnp.asarray(np_(a)) for a in (xs_t, ys_t, rx, ry, ray,
                                                 parity))

    def j_strong(state, key):
        return j_pm._propagate_color_strong(
            state, 0, 0, key, cj, None, ref, src, st, dyn, *grids,
            edge=jnp.asarray(edge), edge_dist=j_erd(jnp.asarray(edge)))

    j_in = (JState(**{f: jnp.asarray(np_(getattr(state_t, f)))
                      for f in ("plane", "cost", "sel_views", "view_weights",
                                "weak", "radius")}), draws.derive(path_it))
    want = compile_jax(j_strong, *j_in)(*j_in)
    got = t_pm._propagate_color_strong(
        state_t, 0, 0, path_it, draws, ct, None, ref_t, src_t,
        convert.static_params(st), convert.dynamic_params(dyn), xs_t, ys_t,
        rx, ry, ray, parity, edge=edge_t, edge_dist=t_erd(edge_t))
    plane_ok = (np.abs(np_(got.plane) - np.asarray(want.plane))
                <= 1e-4).all(-1)
    moved = (np.asarray(want.plane) != plane).any(-1)
    print(f"warp strong half: planes within 1e-4 at {plane_ok.mean():.4f}, "
          f"{int(moved.sum())} pixels moved")
    assert int(moved.sum()) > 100
    assert plane_ok.mean() >= 0.99, plane_ok.mean()
