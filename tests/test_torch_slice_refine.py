"""The round-0 slice pixel by pixel, REFINE_ITER: the pass that follows
FIRST_INIT (geometric consistency on, the radius map of the FIRST_INIT
output), 48x64, V=4, one iteration, through JAX's "exact" backend and the
port's "exact" backend on the CPU.

Both start from one FIRST_INIT output (the port's, as the numpy arrays a
JAX pass returns): JAX takes the arrays, the port takes them through
``convert.pass_output``.  The source depths of the geometric term are the
scene's ground truth.  See test_torch_slice.py for why the bounds with the
port's own math are shares of pixels, and for the check with JAX's math.
"""

import numpy as np
import pytest

from test_torch_support import (SLICE_H, SLICE_W, acc2, agreement, jax_math,
                                jax_pass, np_, port_pass, slice_problem)

from dvpmvs.config import RunState

from dvpmvs_torch import convert

_FIELDS = ("depth", "normal_world", "cost", "weak", "sel_views",
           "view_weights", "radius")


@pytest.fixture(scope="module")
def refine():
    """(scene, first pass as numpy, JAX's REFINE_ITER, the port's
    REFINE_ITER as a function of nothing)."""
    scene, edge, st0, dyn0 = slice_problem(0)
    first = port_pass(scene, edge, st0, dyn0)
    first_np = {k: np_(getattr(first, k)) for k in _FIELDS}
    init = convert.pass_output(first_np, device="cpu")

    _, _, st, dyn = slice_problem(1)
    assert st.state == RunState.REFINE_ITER and st.geom_consistency
    src_depths = scene.gt_depth[1:]
    plane_world = np.concatenate([first_np["normal_world"],
                                  first_np["depth"][..., None]], -1)
    want = jax_pass(scene, edge, st, dyn, init_plane_world=plane_world,
                    init_sel_views=first_np["sel_views"],
                    init_weak=first_np["weak"], src_depths=src_depths,
                    radius_map=first_np["radius"])
    run = lambda: port_pass(
        scene, edge, st, dyn,
        init_plane_world=np.concatenate(
            [np_(init.normal_world), np_(init.depth)[..., None]], -1),
        init_sel_views=init.sel_views, init_weak=init.weak,
        src_depths=src_depths, radius_map=init.radius)
    return scene, first_np, want, run


def test_refine_iter_slice_matches_jax_exact(refine):
    """With the port's own math.  Measured on an AMD EPYC host (AVX-512,
    torch 2.13): depth within 1e-4 on 98.2 % of pixels and within 1 % on
    all; weak classes and selected views equal everywhere; costs more than
    1e-4 apart at 0.23 % of pixels.  The port's pass from the same inputs
    and draws on a second host (an H100 machine's CPU, AVX-512, torch
    2.11), held against the first host's JAX pass: 97.9 % within 1e-4,
    costs 0.10 % apart (tests/torch_host_agreement.py; JAX's own pass was
    not run there).  The bound within 1e-4 is 97.5 %, below both: the
    port's exp, sin and cos move with the host and the torch version.  The
    exact check is test_refine_iter_slice_with_jax_math_matches_everywhere."""
    scene, first_np, want, run = refine
    got = run()
    s = agreement(got, want)
    print(f"REFINE_ITER slice, port vs JAX exact: {s}")
    assert tuple(got.depth.shape) == (SLICE_H, SLICE_W)
    assert s["depth_1pct"] >= 0.999, s
    assert s["depth_1e4"] >= 0.975, s
    assert s["weak"] >= 0.99 and s["sel"] >= 0.99, s
    assert s["cost_off"] <= 0.005, s
    gt = scene.gt_depth[0]
    assert acc2(np_(got.depth), gt) >= acc2(first_np["depth"], gt) - 0.02


def test_refine_iter_slice_with_jax_math_matches_everywhere(refine):
    """With JAX's exp, sin, cos, rsqrt and sigmoid (``jax_math``) the two
    packages agree at every pixel: depth within 1e-4, costs within 1e-4,
    and weak classes, selected views, view weights and radii equal."""
    _, _, want, run = refine
    with jax_math():
        got = run()
    s = agreement(got, want)
    print(f"REFINE_ITER slice with JAX's math: {s}")
    assert s["depth_1e4"] == 1.0 and s["cost_off"] == 0.0, s
    for name in ("weak", "sel_views", "view_weights", "radius"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
