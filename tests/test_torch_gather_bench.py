"""K6, the gather microbenchmark (dvpmvs_torch/bench/gather_variants.py),
against the Pallas kernels of scripts/bench_gather_variants.py in interpret
mode, on a (1, 2) grid of 8 x 128 tiles, on the CPU, where ``run`` takes
each kernel's plain version.  The inputs come from the port's numpy seed and
are carried into JAX as arrays.

Bounds: the five int32 variants equal; quad8 and p2x5 (f32 sums of 612
steps in one order) within 1e-6 relative.  Measured: the int variants
equal, quad8 and p2x5 within 1.0e-7 and 7.5e-8 relative (XLA contracts a
multiply-add that the port rounds twice).

Then the CUDA kernel's own arithmetic, which runs only on the card, is
modelled here in numpy step by step as csrc/gather_bench.cu writes it: the
per-tap terms from ``tap_table``, the rows each variant stages in shared
memory, int32 index chains, bytes to f32 by PRMT and one fma; the model
equals ``run_plain`` bit for bit.  Also the floor's pieces: the addresses
``step_addresses`` gives, the bank-conflict count and the SASS parser.
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
from dvpmvs_torch.bench import sass
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


# ---- the CUDA kernel's arithmetic, modelled in numpy ------------------------

_ROLL = (1, 3, 6, 10, 15, 21, 28, 29)
_ZERO_SEL = 0x7654              # csrc/gather_bench.cu kZeroByte
_BYTE0 = 0x7650                 # kByte0


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte k of the result is byte (sel >> 4k) & 7 of
    the 8 bytes y:x."""
    x, y, sel = np.broadcast_arrays(*(np.asarray(a, np.uint32)
                                      for a in (x, y, sel)))
    src = np.stack([(x >> np.uint32(8 * k)) & np.uint32(0xFF)
                    for k in range(4)] + [(y >> np.uint32(8 * k))
                                          & np.uint32(0xFF)
                                          for k in range(4)])
    out = np.zeros(x.shape, np.uint32)
    for k in range(4):
        idx = ((sel >> np.uint32(4 * k)) & np.uint32(7)).astype(np.int64)
        out |= np.take_along_axis(src, idx[None], 0)[0] << np.uint32(8 * k)
    return out


def _byte_times(g, sel, c):
    """byte_times: f = the PRMT's f32 (2^23 + b), then fma(f, c, -2^23 c)
    rounded once (exact in float64 before the one rounding)."""
    f = _byte_perm(g, 0x4B000000, sel).view(np.float32)
    c = np.float32(c)
    return (f.astype(np.float64) * np.float64(c)
            + np.float64(np.float32(-8388608.0) * c)).astype(np.float32)


def _staged(variant, quads):
    """The words the kernel stages: quad8 rows 0-47, p2x5 rows 0-31, the
    prims rows 0-31 of columns 0-127 and 8 zero words; reads past them
    raise IndexError."""
    q = np_(quads).view(np.uint32)
    if variant == "quad8":
        return q[:48].reshape(-1)
    if variant == "p2x5":
        return q[:32].reshape(-1)
    return np.concatenate([q[:32, :128].reshape(-1), np.zeros(8, np.uint32)])


def _kernel_model(variant, taps, djs, locs, quads):
    """[Hd, Wd] f32 and the per-tap load addresses, as the CUDA kernel
    computes them (int32 arithmetic, its clamps and limits)."""
    table = np_(gv.tap_table(variant, taps)).astype(np.int32)
    djs, locs = np_(djs).astype(np.int32), np_(locs).astype(np.int32)
    Hd, Wd = djs.shape
    smem = _staged(variant, quads)
    s = np.broadcast_to((np.arange(Hd, dtype=np.int32) & 7)[:, None],
                        (Hd, Wd))
    l = np.broadcast_to((np.arange(Wd, dtype=np.int32) & 127)[None, :],
                        (Hd, Wd))
    dj0, loc0 = np.clip(djs, -8, 8), np.clip(locs, -4, 256)
    addrs, vals = [], []
    for T0, T1, base, fa, fb, fc in table:
        base //= 4                              # bytes -> words
        dj = np.clip(dj0 + T0, 0, 7)
        if variant == "quad8":
            loc = np.clip(loc0 + T1, 0, 255)
            n = s + dj
            r = n & 7
            row = 8 * ((n >> 3) + (r >= fb)) + ((r - fa) & 7)
            ad = [base + row * 256 + loc]
            g = smem[ad[0]]
            v = (_byte_times(g, _BYTE0, 0.3)
                 + _byte_times(g, _BYTE0 + 1, 0.2))
            v = v + _byte_times(g, _BYTE0 + 2, 0.25)
            vals.append(v + _byte_times(g, _BYTE0 + 3, 0.25))
        elif variant == "p2x5":
            loc = np.clip(loc0 + T1, 0, 255)
            w = base + ((s + (dj & ~1) + fa) & 7) * 256
            ad = [w + loc, w + np.minimum(loc + 1, 255)]
            ga, gb = smem[ad[0]], smem[ad[1]]
            sel = 0x7600 | (_byte_perm(fb, fc, dj) & 0xFF).astype(np.int64)
            v = _byte_times(ga, sel, 0.3) + _byte_times(gb, sel, 0.2)
            v = v + _byte_times(ga, sel + 1, 0.25)
            vals.append(v + _byte_times(gb, sel + 1, 0.25))
        else:
            loc = np.clip(loc0 + T1, 0, 127)
            if variant == "prim_roll":
                ad = [base + ((s - S) & 7) * 128 + l for S in _ROLL]
            elif variant == "prim_gather":
                ad = [base + s * 128 + loc + j for j in range(8)]
            else:
                ad = [base + s * 128 + l] * 8
            vals.append((loc, [smem[x] for x in ad]))
        addrs.append(ad)
    if variant in gv.FLOAT_VARIANTS:
        acc = np.zeros((Hd, Wd), np.float32)
        for _ in range(gv.PV):
            for v in vals:
                acc = acc + v
        return acc, addrs
    acc = np.zeros((Hd, Wd), np.uint32)
    for _ in range(gv.PV):
        for loc, words in vals:
            for j, w in enumerate(words):
                if variant == "prim_gather":
                    acc = acc + np.where(loc <= 127 - j, w,
                                         np.uint32(0x80000000))
                elif variant == "prim_select":
                    acc = np.where((loc & 7) == j, w, acc)
                elif variant == "prim_vshift":
                    acc = acc + (w >> (((loc + j) & 3) << 3).astype(
                        np.uint32))
                else:
                    acc = acc + w
    return acc.view(np.int32).astype(np.float32), addrs


def _random_inputs(grid, seed):
    """make_inputs' taps and quads, and a dj and loc of their own at every
    pixel (make_inputs repeats one tile)."""
    taps, djs, locs, quads = gv.make_inputs(seed=seed, grid=grid)
    rng = np.random.default_rng(seed + 100)
    return (taps,
            torch.as_tensor(rng.integers(0, 6, djs.shape, dtype=np.int32)),
            torch.as_tensor(rng.integers(0, 254, locs.shape, dtype=np.int32)),
            quads)


@pytest.mark.parametrize("variant", gv.VARIANTS)
def test_tap_table_terms(variant):
    """tap_table holds each tap's uniform terms as run_plain's formulas
    (Python's floor modulo) give them, for taps in and out of [0, 4)."""
    taps = torch.as_tensor(np.random.default_rng(7).integers(
        -9, 10, (gv.TAPS, 2), dtype=np.int32))
    table = gv.tap_table(variant, taps)
    assert table.dtype == torch.int32 and tuple(table.shape) == (36, 6)
    stride = 256 if variant in gv.FLOAT_VARIANTS else 128
    for (T0, T1), row in zip(taps.tolist(), table.tolist()):
        up = T1 % 7 + 1
        want = {"quad8": [up, 8 - up % 8, 0]}.get(variant, [0, 0, 0])
        if variant == "p2x5":
            m0 = T1 % 3
            codes = [0x50 + dj % 2 if 0 <= dj // 2 - m0 + 1 <= 3 else 0x54
                     for dj in range(8)]
            want = [2 * (1 - m0)] + [sum(c << 8 * i for i, c in enumerate(
                codes[k:k + 4])) for k in (0, 4)]
        assert row == [T0, T1, 4 * 8 * T0 * stride] + want


@pytest.mark.parametrize("grid", [(1, 2), (3, 5)])
@pytest.mark.parametrize("variant", gv.VARIANTS)
def test_kernel_chain_model_matches_plain(variant, grid):
    """The CUDA kernel's index chains from tap_table, its staged rows and
    its PRMT byte-to-float give run_plain's output bit for bit."""
    ins = _random_inputs(grid, seed=11)
    got, _ = _kernel_model(variant, *ins)
    want = np_(gv.run_plain(variant, *ins))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("variant", gv.VARIANTS)
def test_kernel_chain_model_at_int32_limits(variant):
    """dj and loc anywhere in int32: the kernel's limits (dj to [-8, 8], loc
    to [-4, 256] before the taps' add) keep its int32 sums from wrapping and
    change no clamp, so it still equals run_plain (int64) bit for bit."""
    taps, djs, locs, quads = gv.make_inputs(seed=5, grid=(1, 1))
    rng = np.random.default_rng(9)
    lim = np.iinfo(np.int32)
    djs, locs = (rng.integers(lim.min, lim.max, (8, 128), dtype=np.int64)
                 .astype(np.int32) for _ in range(2))
    djs[0, :4] = locs[0, :4] = [lim.max, lim.min, 257, -5]
    ins = (taps, torch.as_tensor(djs), torch.as_tensor(locs), quads)
    got, _ = _kernel_model(variant, *ins)
    want = np_(gv.run_plain(variant, *ins))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_prmt_byte_to_float_is_exact():
    """PRMT of byte i under 0x4B000000 is the f32 2^23 + b for every byte b
    at every place i, fma(f, c, -2^23 c) is b c rounded once (f32's own
    product), and the zero selectors give 0."""
    b = np.arange(256, dtype=np.uint32)
    rng = np.random.default_rng(1)
    for i in range(4):
        other = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(
            np.uint32) & ~np.uint32(0xFF << (8 * i))
        g = other | (b << np.uint32(8 * i))
        f = _byte_perm(g, 0x4B000000, _BYTE0 + i).view(np.float32)
        np.testing.assert_array_equal(f - np.float32(2 ** 23),
                                      b.astype(np.float32))
        for c in (0.3, 0.2, 0.25):
            want = b.astype(np.float32) * np.float32(c)
            np.testing.assert_array_equal(
                _byte_times(g, _BYTE0 + i, c).view(np.int32),
                want.view(np.int32))
    for sel in (_ZERO_SEL, _ZERO_SEL + 1):
        np.testing.assert_array_equal(_byte_times(g, sel, 0.3), 0.0)


@pytest.mark.parametrize("variant", gv.VARIANTS)
def test_step_addresses_are_the_kernel_loads(variant):
    """The loads the floor counts wavefronts of are the kernel model's:
    the same distinct addresses at every tap."""
    ins = _random_inputs((1, 2), seed=12)
    _, addrs = _kernel_model(variant, *ins)
    got = gv.step_addresses(variant, *ins[:3])
    assert len(got) == len(addrs) == gv.TAPS
    key = lambda arrs: sorted({np.asarray(a, np.int64).tobytes()
                               for a in arrs})
    for g, a in zip(got, addrs):
        assert key(np_(g)) == key(np.broadcast_to(x, ins[1].shape)
                                  for x in a)
    n_loads = {"prim_roll": 7, "prim_gather": 8, "prim_select": 8,
               "p2x5": 2}.get(variant, 1)
    assert got[0].shape[0] == n_loads


def test_wavefronts_count_distinct_words_per_bank():
    """A warp-wide 32-bit load takes as many wavefronts as the most distinct
    words any bank serves; lanes reading one word share it."""
    rng = np.random.default_rng(3)
    addr = rng.integers(0, 300, (50, 32))
    addr[0] = np.arange(32)                 # conflict-free
    addr[1] = 7                             # one word, broadcast
    addr[2] = np.arange(32) * 32            # one bank, 32 words
    want = [max(len({int(a) for a in row if a % 32 == b})
                for b in range(32)) for row in addr]
    got = gv._wavefronts(torch.as_tensor(addr))
    assert got.tolist() == want
    assert want[:3] == [1, 1, 32]


_SASS = """
\t\tFunction : _Z13gather_kernelILi0EEvv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   I2F.RP R0, R9 ;
.L_x_1:
        /*0020*/                   LDS R2, [R3] ;
        /*0030*/                   PRMT R4, R2, 0x7650, R5 ;
        /*0040*/                   FFMA R6, R4, R7, -2097152 ;
        /*0050*/               @!P0 IMAD.MOV.U32 R8, RZ, RZ, R6 ;
        /*0060*/                   VIADDMNMX R9, R9, UR4, RZ, !PT ;
.L_x_2:
        /*0070*/                   IADD3 R10, R10, 0x1, RZ ;
        /*0080*/                   ISETP.NE.AND P1, PT, R10, 0x4, PT ;
        /*0090*/               @P1 BRA `(.L_x_2) ;
        /*00a0*/                   ULDC UR5, c[0x0][0x210] ;
        /*00b0*/                   VIADD R11, R11, 0x1 ;
        /*00c0*/                   ISETP.NE.AND P0, PT, R11, 0x11, PT ;
        /*00d0*/               @P0 BRA `(.L_x_1) ;
        /*00e0*/                   EXIT ;
\t\tFunction : _Z12empty_kernelv
        /*0000*/                   EXIT ;
"""


def test_sass_loop_counts():
    """The parser finds each function, takes the innermost loop with the
    most instructions (a loop inside another does not count as the outer
    one's), strips predicates and modifiers and counts by pipe."""
    funcs = sass.functions(_SASS)
    assert sorted(funcs) == ["_Z12empty_kernelv", "_Z13gather_kernelILi0EEvv"]
    insns = funcs["_Z13gather_kernelILi0EEvv"]
    assert [t for _, t, _ in sass.innermost_loop(insns)] == [
        "IADD3 R10, R10, 0x1, RZ", "ISETP.NE.AND P1, PT, R10, 0x4, PT",
        "@P1 BRA `(.L_x_2)"]
    assert sass.opcode("@!P0 IMAD.MOV.U32 R8, RZ, RZ, R6") == "IMAD"
    assert [sass.pipe_of(op) for op in ("PRMT", "FFMA", "IMAD", "VIADD",
                                        "VIADDMNMX", "I2F", "LDS", "ULDC",
                                        "BRA")] == [
        "alu", "fp32", "imad", "imad", "alu", "conv", "shared", "uniform",
        "other"]
    c = sass.loop_counts(insns)
    assert c["pipes"] == {"alu": 2, "other": 1, "issue": 3, "fma": 0}
    assert c["conversions"] == ["I2F"]
    assert sass.loop_counts(funcs["_Z12empty_kernelv"])["pipes"] == {
        "issue": 0, "fma": 0}


def test_floor_takes_the_larger_of_wavefronts_and_pipes():
    """floor_ms: 17 passes over the units on the SMs, each pass's loads
    times the wavefronts a load, or a pipe's instructions over its lanes."""
    units, sms, mhz = 4864, 132, 2000.0
    per_unit = gv.PV * units / sms
    counts = {"pipes": {"shared": 36, "alu": 720, "fp32": 288, "issue": 1100}}
    ms, by = gv.floor_ms(counts, 3.5, units, sms, mhz)
    assert by == "alu pipe"
    assert ms == pytest.approx(per_unit * 720 * 32 / 64 / (mhz * 1e3))
    ms, by = gv.floor_ms(counts, 12.0, units, sms, mhz)
    assert by == "shared wavefronts"
    assert ms == pytest.approx(per_unit * 36 * 12.0 / (mhz * 1e3))
