"""The round-0 slice pixel by pixel, FIRST_INIT: a 48x64, V=4,
one-iteration pass with Canny edges (the edge-adaptive branch) through JAX's
"exact" backend and the port's "exact" backend on the CPU, from the same
inputs and the same random numbers (the jax-backed draw source).

Propagation is chaotic: a last-bit difference in a cost (the port's exp
and sums round differently from XLA's) can flip an argmin between
near-equal candidates at a few pixels, and the 21-tap median filter then
spreads each flipped depth to its neighbours.  So the test bounds the share
of pixels that agree, not every pixel.  For scale: JAX against itself, with
the pass compiled at XLA's default and at its cheapest optimisation level,
agrees on 89.3 % of the depths within 1e-4 and on 99.15 % within 1 %.

The last bits come from exp, sin, cos, rsqrt and sigmoid alone, which
neither library rounds correctly and whose rounding moves with the host:
with JAX's functions in the port (``jax_math``) the passes agree at every
pixel, which is the exact check.
"""

import numpy as np
import pytest

from test_torch_support import (SLICE_H, SLICE_W, acc2, agreement, jax_math,
                                jax_pass, np_, port_pass, slice_problem)

from dvpmvs.config import RunState


@pytest.fixture(scope="module")
def first_init():
    scene, edge, st, dyn = slice_problem(0)
    assert st.state == RunState.FIRST_INIT
    return scene, edge, st, dyn, jax_pass(scene, edge, st, dyn)


def test_first_init_slice_matches_jax_exact(first_init):
    """Measured: depth within 1e-4 on 97.7 % of pixels and within 1 % on
    99.15 %; weak classes and selected views equal everywhere; costs more
    than 1e-4 apart at 0.13 % of pixels."""
    scene, edge, st, dyn, want = first_init
    got = port_pass(scene, edge, st, dyn)
    s = agreement(got, want)
    print(f"FIRST_INIT slice, port vs JAX exact: {s}")
    assert tuple(got.depth.shape) == (SLICE_H, SLICE_W)
    assert s["depth_1pct"] >= 0.99, s
    assert s["depth_1e4"] >= 0.97, s
    assert s["weak"] >= 0.99 and s["sel"] >= 0.99, s
    assert s["cost_off"] <= 0.005, s
    gt = scene.gt_depth[0]
    assert acc2(got.depth.numpy(), gt) == pytest.approx(
        acc2(want.depth, gt), abs=0.01)


def test_first_init_slice_with_jax_math_matches_everywhere(first_init):
    """With JAX's exp, sin, cos, rsqrt and sigmoid: depth within 1e-4 and
    costs within 1e-4 at every pixel (97.4 % of the depths are bitwise
    equal: the compiled JAX pass reassociates a few sums); weak classes,
    selected views, view weights and radii equal."""
    scene, edge, st, dyn, want = first_init
    with jax_math():
        got = port_pass(scene, edge, st, dyn)
    s = agreement(got, want)
    print(f"FIRST_INIT slice with JAX's math: {s}")
    assert s["depth_1e4"] == 1.0 and s["cost_off"] == 0.0, s
    for name in ("weak", "sel_views", "view_weights", "radius"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
