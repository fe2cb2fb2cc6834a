"""K6: the gather microbenchmark (counterpart of
``scripts/bench_gather_variants.py``).

Seven kernels that run only gather machinery: for every pixel of a
[Hd, Wd] grid, 17 x 36 steps, each reading words of a 64 x 256 int32 source
block at offsets from ``taps`` and the per-pixel ``djs`` / ``locs``:
``quad8`` and ``p2x5`` (two source layouts of the NCC kernel's inner gather,
f32 sums) and the primitives ``prim_roll``, ``prim_gather``,
``prim_select``, ``prim_repeat`` and ``prim_vshift`` (int32 sums that wrap,
cast to f32).  ``csrc/gather_bench.cu`` says what each computes.

``run`` launches the kernel for tensors on the card (counted under
``gather_bench`` and ``gather_bench/<variant>``) and ``run_plain`` (the same
function in plain PyTorch) for tensors on the CPU.  ``taps`` always lie in
host memory, as the TPU kernel's SMEM scalars: the launch passes them by
value.  The inputs are drawn from a numpy seed at the shapes and ranges of
the JAX script (which draws with ``jax.random``).

    python -m dvpmvs_torch.bench.gather_variants

times the seven kernels on the card with CUDA events and prints the
quad8 / p2x5 ratio beside the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build

TILE_H, TILE_W = 8, 128
GRID = (38, 4)              # the JAX script's grid of 8 x 128 tiles
TAPS = 36
PV = 17
QUAD_SHAPE = (64, 256)
VARIANTS = ("quad8", "p2x5", "prim_roll", "prim_gather", "prim_select",
            "prim_repeat", "prim_vshift")
FLOAT_VARIANTS = ("quad8", "p2x5")
_NAME = "gather_bench"
_INT32_MIN = -2 ** 31
# cumulative sublane shift after inner step j of prim_roll (1 + j % 7 each)
_ROLL_SHIFT = np.cumsum([1 + j % 7 for j in range(8)])


def make_inputs(seed: int = 0, grid=GRID, device="cpu"):
    """(taps [36, 2], djs [Hd, Wd], locs [Hd, Wd], quads [64, 256]), all
    int32, with Hd, Wd = 8 grid[0], 128 grid[1]: one 8 x 128 tile of
    dj in [0, 6) and loc in [0, 254) repeated over the grid, random int32
    quads and taps in [0, 4), as the JAX script makes them.  The taps stay
    on the CPU; the rest go to ``device``."""
    rng = np.random.default_rng(seed)
    dj = rng.integers(0, 6, (TILE_H, TILE_W), dtype=np.int32)
    loc = rng.integers(0, 254, (TILE_H, TILE_W), dtype=np.int32)
    quads = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                         QUAD_SHAPE, dtype=np.int32)
    taps = rng.integers(0, 4, (TAPS, 2), dtype=np.int32)
    tile = lambda a: np.tile(a, grid)
    return (torch.as_tensor(taps),) + tuple(
        torch.as_tensor(a, device=device) for a in (tile(dj), tile(loc),
                                                    quads))


def _check(taps, djs, locs, quads):
    Hd, Wd = djs.shape
    if (tuple(taps.shape) != (TAPS, 2) or tuple(locs.shape) != (Hd, Wd)
            or tuple(quads.shape) != QUAD_SHAPE or Hd % TILE_H
            or Wd % TILE_W):
        raise ValueError("gather_bench: taps [36, 2], djs and locs [Hd, Wd] "
                         "in 8 x 128 tiles and quads [64, 256] expected")
    if any(t.dtype != torch.int32 for t in (taps, djs, locs, quads)):
        raise ValueError("gather_bench: int32 inputs expected")
    if locs.device != djs.device or quads.device != djs.device:
        raise ValueError("gather_bench: djs, locs and quads on one device "
                         "expected")
    if taps.device.type != "cpu":
        raise ValueError("gather_bench: taps lie in host memory")
    if int(taps.min()) < 0 or int(taps.max()) > 3:
        raise ValueError("gather_bench: taps must lie in [0, 4)")


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement)."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def _step_values(variant, taps, djs, locs, quads):
    """One [Hd, Wd] tensor per tap: its f32 contribution (quad8, p2x5) or
    its int64 contribution summed over the 8 inner steps (the prims; for
    prim_select the value the step leaves)."""
    Hd, Wd = djs.shape
    dev = djs.device
    s = (torch.arange(Hd, device=dev) % TILE_H)[:, None].expand(Hd, Wd)
    lane = (torch.arange(Wd, device=dev) % TILE_W)[None, :].expand(Hd, Wd)
    q = quads.to(torch.int64)
    word = lambda row, col: q[row, col]
    byte = lambda g, i: ((g >> (8 * i)) & 0xFF).to(torch.float32)
    c3, c2, c25 = _f32(0.3, djs), _f32(0.2, djs), _f32(0.25, djs)
    dj0, loc0 = djs.to(torch.int64), locs.to(torch.int64)
    vals = []
    for T0, T1 in taps.tolist():
        if variant in FLOAT_VARIANTS:
            dj = torch.clamp(dj0 + T0, 0, 7)
            loc = torch.clamp(loc0 + T1, 0, 255)
            if variant == "quad8":
                up = T1 % 7 + 1
                n = s + dj
                r = n & 7
                hi = (r >= 8 - up % 8).to(torch.int64)
                row = 8 * T0 + 8 * ((n >> 3) + hi) + torch.remainder(r - up,
                                                                     8)
                g = word(row, loc) & 0xFFFFFFFF
                b = [byte(g, i) for i in range(4)]
                v = b[0] * c3 + b[1] * c2
                v = v + b[2] * c25
                vals.append(v + b[3] * c25)
            else:
                j = (dj >> 1) - T1 % 3 + 1
                ok = (j >= 0) & (j <= 3)
                row = 8 * T0 + ((s + 2 * j) & 7)
                sh = (dj & 1) << 3
                zero = torch.zeros_like(row)
                ga = torch.where(ok, word(row, loc) & 0xFFFFFFFF, zero) >> sh
                gb = torch.where(ok, word(row, torch.clamp(loc + 1, max=255))
                                 & 0xFFFFFFFF, zero) >> sh
                v = byte(ga, 0) * c3 + byte(gb, 0) * c2
                v = v + byte(ga, 1) * c25
                vals.append(v + byte(gb, 1) * c25)
            continue
        loc = torch.clamp(loc0 + T1, 0, 127)
        blk = lambda r, c: word(8 * T0 + r, c)
        if variant == "prim_select":        # the step j = loc & 7 writes
            vals.append(blk(s, lane))
            continue
        acc = torch.zeros_like(dj0)
        for j in range(8):
            if variant == "prim_roll":
                acc = acc + blk(torch.remainder(s - int(_ROLL_SHIFT[j]), 8),
                                lane)
            elif variant == "prim_gather":
                c = loc + j
                acc = acc + torch.where(c <= 127,
                                        blk(s, torch.clamp(c, max=127)),
                                        torch.full_like(c, _INT32_MIN))
            elif variant == "prim_repeat":
                acc = acc + blk(s, lane)
            else:                           # prim_vshift, logical shift
                acc = acc + ((blk(s, lane) & 0xFFFFFFFF)
                             >> (((loc + j) & 3) << 3))
        vals.append(acc)
    return vals


def run_plain(variant, taps, djs, locs, quads) -> torch.Tensor:
    """The plain version of the K6 kernel ``variant``: [Hd, Wd] f32."""
    if variant not in VARIANTS:
        raise ValueError(f"gather_bench: unknown variant {variant!r}")
    _check(taps, djs, locs, quads)
    vals = _step_values(variant, taps, djs, locs, quads)
    if variant in FLOAT_VARIANTS:
        acc = torch.zeros(djs.shape, dtype=torch.float32, device=djs.device)
        for _ in range(PV):
            for v in vals:
                acc = acc + v
        return acc
    if variant == "prim_select":
        return _wrap32(vals[-1]).to(torch.float32)
    acc = torch.zeros(djs.shape, dtype=torch.int64, device=djs.device)
    for _ in range(PV):
        for v in vals:
            acc = torch.remainder(acc + v, 2 ** 32)
    return _wrap32(acc).to(torch.float32)


def run(variant, taps, djs, locs, quads) -> torch.Tensor:
    """K6 kernel ``variant`` on (taps, djs, locs, quads) -> [Hd, Wd] f32."""
    if variant not in VARIANTS:
        raise ValueError(f"gather_bench: unknown variant {variant!r}")
    if djs.device.type == "cpu":
        return run_plain(variant, taps, djs, locs, quads)
    if djs.device.type != "cuda":
        raise ValueError(f"gather_bench: unsupported device {djs.device}")
    _check(taps, djs, locs, quads)
    ins = [t.contiguous() for t in (taps, djs, locs, quads)]   # taps: host
    Hd, Wd = djs.shape
    out = torch.empty((Hd, Wd), dtype=torch.float32, device=djs.device)
    fn = _build.library(_NAME).launch_gather_bench
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    P = _build.ptr
    err = fn(VARIANTS.index(variant), *(P(t) for t in ins), P(out), Hd, Wd,
             ctypes.c_void_p(_build.stream_ptr(out)))
    _build.check(err, _NAME, variant)
    return out


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event time of fn() over reps launches (after a warm-up).

    The card first spins for ~20 ms while the host queues the launches
    behind it, so a kernel shorter than its host-side launch cost is timed
    on the device, not at the rate the host launches it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)          # clock cycles, ~20 ms at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    ins = make_inputs(device="cuda")
    times = {}
    for variant in VARIANTS:
        times[variant] = cuda_ms(lambda: run(variant, *ins))
        print(f"{variant:12s} {times[variant]:9.4f} ms", flush=True)
    print(f"\nquad8 {times['quad8']:.4f} ms vs p2x5 {times['p2x5']:.4f} ms "
          f"({times['quad8'] / max(times['p2x5'], 1e-9):.2f}x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
