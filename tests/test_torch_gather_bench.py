"""K6, the gather microbenchmark (dvpmvs_torch/bench/gather_variants.py),
against the Pallas kernels of scripts/bench_gather_variants.py in interpret
mode, on a (1, 2) grid of 8 x 128 tiles, on the CPU, where ``run`` takes
each kernel's plain version.  The inputs come from the port's numpy seed and
are carried into JAX as arrays.

Bounds: the five int32 variants equal; quad8 and p2x5 (f32 sums of 612
steps in one order) within 1e-6 relative.  Measured: the int variants
equal, quad8 and p2x5 within 1.0e-7 and 7.5e-8 relative (XLA contracts a
multiply-add that the port rounds twice).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_support import np_

from dvpmvs_torch.bench import gather_variants as gv
from dvpmvs_torch.kernels import _build

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import bench_gather_variants as j_bench  # noqa: E402

GRID = (1, 2)


def _jax_kernel(variant):
    if variant == "quad8":
        return j_bench.quad8_kernel
    if variant == "p2x5":
        return j_bench.p2x5_kernel
    return j_bench.prim_kernel_factory(variant[len("prim_"):])


def _jax_run(kern, taps, djs, locs, quads):
    """``bench_gather_variants.run`` on GRID, in interpret mode."""
    spec = pl.BlockSpec((gv.TILE_H, gv.TILE_W), lambda i, j: (i, j),
                        memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kern, grid=GRID,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), spec, spec,
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(
            (GRID[0] * gv.TILE_H, GRID[1] * gv.TILE_W), jnp.float32),
        interpret=True)(taps, djs, locs, quads)


@pytest.fixture(scope="module")
def inputs():
    t_ins = gv.make_inputs(seed=3, grid=GRID)
    # a tile of its own per grid cell, so that the two cells differ
    rng = np.random.default_rng(4)
    djs = rng.integers(0, 6, t_ins[1].shape, dtype=np.int32)
    locs = rng.integers(0, 254, t_ins[2].shape, dtype=np.int32)
    t_ins = (t_ins[0], torch.as_tensor(djs), torch.as_tensor(locs),
             t_ins[3])
    return t_ins, tuple(jnp.asarray(np_(t)) for t in t_ins)


@pytest.mark.parametrize("variant", gv.VARIANTS)
def test_gather_bench_plain_matches_jax_interpret(inputs, variant):
    t_ins, j_ins = inputs
    want = np.asarray(_jax_run(_jax_kernel(variant), *j_ins))
    _build.reset_launches()
    got = np_(gv.run(variant, *t_ins))
    assert _build.LAUNCHES["gather_bench"] == 0
    assert got.shape == want.shape == (8, 256)
    if variant in gv.FLOAT_VARIANTS:
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        print(f"{variant}: max rel {rel.max():.2e}")
        assert rel.max() <= 1e-6, rel.max()
    else:
        np.testing.assert_array_equal(got, want)


def test_make_inputs_shapes_and_ranges():
    taps, djs, locs, quads = gv.make_inputs()
    assert tuple(djs.shape) == tuple(locs.shape) == (304, 512)
    assert tuple(quads.shape) == (64, 256) and tuple(taps.shape) == (36, 2)
    assert all(t.dtype == torch.int32 for t in (taps, djs, locs, quads))
    assert 0 <= int(djs.min()) and int(djs.max()) < 6
    assert 0 <= int(locs.min()) and int(locs.max()) < 254
    assert 0 <= int(taps.min()) and int(taps.max()) < 4
    # the tile repeats over the grid, as the JAX script's inputs
    assert torch.equal(djs[:8, :128], djs[296:, 384:])
