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
host memory, as the TPU kernel's SMEM scalars: the launch passes their
per-tap terms (``tap_table``) by value.  The inputs are drawn from a numpy
seed at the shapes and ranges of the JAX script (which draws with
``jax.random``).

``floors`` gives each kernel's floor of the work as written: the larger of
its shared-memory wavefronts (counted from the inputs' addresses) and its
busiest pipe (instructions a step from the SASS, ``bench/sass.py``), over
the SMs at the sampled SM clock.

    python -m dvpmvs_torch.bench.gather_variants

times the seven kernels and an empty launch on the card with CUDA events
and prints each beside its floor, registers and resident blocks an SM, the
quad8 / p2x5 ratio, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from . import sass

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
WARP = 32


def staged_stride(variant) -> int:
    """Words a staged row of quads holds in the kernel's shared memory:
    whole rows for quad8 and p2x5, columns 0-127 for the prims."""
    return QUAD_SHAPE[1] if variant in FLOAT_VARIANTS else TILE_W


def tap_table(variant, taps) -> torch.Tensor:
    """The per-tap terms the K6 kernel ``variant`` reads from its parameter
    block, [36, 6] int32 on the CPU, a row a tap: T0, T1, the byte offset
    of the tap's 8-row block in the staged quads (4 x 8 T0 x
    ``staged_stride``), then
    - quad8: up = T1 mod 7 + 1, 8 - up mod 8, 0;
    - p2x5: 2 (1 - T1 mod 3), the row's shift (s + 2 j with j = dj / 2 -
      T1 mod 3 + 1), and the low byte of the PRMT selector of each dj in
      0..7, four a word: 0x50 + dj mod 2 (byte dj mod 2 of the word), or
      0x54 (a zero byte) where j lies outside 0..3;
    - the prims: 0, 0, 0.
    Floor modulo, as ``run_plain``'s Python ints take it."""
    t = np.asarray(taps, dtype=np.int64)
    t0, t1 = t[:, 0], t[:, 1]
    a = b = c = np.zeros_like(t0)
    if variant == "quad8":
        a = t1 % 7 + 1
        b = 8 - a % 8
    elif variant == "p2x5":
        a = 2 * (1 - t1 % 3)
        dj = np.arange(8)
        j = (dj >> 1)[None, :] - (t1 % 3)[:, None] + 1
        code = np.where((j >= 0) & (j <= 3), 0x50 + (dj & 1), 0x54)
        words = (code << (8 * (dj % 4))).reshape(-1, 2, 4).sum(-1)
        b, c = words[:, 0], words[:, 1]
    base = 4 * 8 * t0 * staged_stride(variant)
    table = np.stack([t0, t1, base, a, b, c], 1)
    return torch.from_numpy(table.astype(np.int32))


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


def _lib():
    lib = _build.library(_NAME)
    fn = lib.launch_gather_bench
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gather_bench_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.gather_bench_info.restype = ctypes.c_int
    lib.launch_gather_bench_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.launch_gather_bench_empty.restype = ctypes.c_int
    return lib


def run(variant, taps, djs, locs, quads) -> torch.Tensor:
    """K6 kernel ``variant`` on (taps, djs, locs, quads) -> [Hd, Wd] f32."""
    if variant not in VARIANTS:
        raise ValueError(f"gather_bench: unknown variant {variant!r}")
    if djs.device.type == "cpu":
        return run_plain(variant, taps, djs, locs, quads)
    if djs.device.type != "cuda":
        raise ValueError(f"gather_bench: unsupported device {djs.device}")
    _check(taps, djs, locs, quads)
    table = tap_table(variant, taps)                     # host memory
    ins = [t.contiguous() for t in (djs, locs, quads)]
    Hd, Wd = djs.shape
    out = torch.empty((Hd, Wd), dtype=torch.float32, device=djs.device)
    P = _build.ptr
    err = _lib().launch_gather_bench(
        VARIANTS.index(variant), P(table), *(P(t) for t in ins), P(out), Hd,
        Wd, ctypes.c_void_p(_build.stream_ptr(out)))
    _build.check(err, _NAME, variant)
    return out


def launch_info(variant, units: int) -> dict:
    """The launch of K6 kernel ``variant`` over ``units`` warp units on the
    current card: blocks an SM it launches, SMs, registers a thread, shared
    memory a block and local memory a thread (bytes), threads a block, and
    the blocks an SM that fit (occupancy API)."""
    vals = (ctypes.c_int * 7)()
    err = _lib().gather_bench_info(VARIANTS.index(variant), units, vals)
    if err != 0:
        raise RuntimeError(f"gather_bench_info failed: cudaError {err}")
    return dict(zip(("blocks_per_sm", "sms", "registers", "shared_bytes",
                     "local_bytes", "threads", "fit_per_sm"), vals))


def empty_launch(units: int) -> str:
    """The launch floor: ``cuda_ms`` of an empty kernel (counted under
    ``gather_bench/empty``) on the grid quad8 launches over ``units`` warp
    units, as one line."""
    info = launch_info("quad8", units)
    blocks = info["blocks_per_sm"] * info["sms"]

    def launch():
        err = _lib().launch_gather_bench_empty(
            blocks, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(err, _NAME, "empty")

    return (f"empty launch ({blocks} blocks of {info['threads']} threads): "
            f"{cuda_ms(launch):.4f} ms")


def step_addresses(variant, taps, djs, locs):
    """Per tap, the word addresses in the kernel's staged quads of each
    load of a step: [loads, Hd, Wd] int64 (quad8 1, p2x5 2, roll 7 (its
    steps 5 and 7 read one row), gather 8, select 8 (one word, each under
    its step's condition), repeat and vshift 1 (one word))."""
    Hd, Wd = djs.shape
    dev = djs.device
    s = (torch.arange(Hd, device=dev) % TILE_H)[:, None].expand(Hd, Wd)
    lane = (torch.arange(Wd, device=dev) % TILE_W)[None, :].expand(Hd, Wd)
    dj0, loc0 = djs.to(torch.int64), locs.to(torch.int64)
    stride = staged_stride(variant)
    out = []
    for t0, t1, base, a, b, _ in tap_table(variant, taps).tolist():
        base //= 4
        dj = torch.clamp(dj0 + t0, 0, 7)
        if variant == "quad8":
            loc = torch.clamp(loc0 + t1, 0, 255)
            n = s + dj
            r = n & 7
            row = 8 * ((n >> 3) + (r >= b).to(torch.int64)) + ((r - a) & 7)
            addrs = [base + row * stride + loc]
        elif variant == "p2x5":
            loc = torch.clamp(loc0 + t1, 0, 255)
            row = base + ((s + (dj & ~1) + a) & 7) * stride
            addrs = [row + loc, row + torch.clamp(loc + 1, max=255)]
        elif variant == "prim_roll":
            addrs = [base + ((s - S) & 7) * stride + lane
                     for S in sorted({int(S) % 8 for S in _ROLL_SHIFT})]
        elif variant == "prim_gather":
            loc = torch.clamp(loc0 + t1, 0, 127)
            addrs = [base + s * stride + loc + j for j in range(8)]
        else:
            n = 8 if variant == "prim_select" else 1
            addrs = [base + s * stride + lane] * n
        out.append(torch.stack(addrs))
    return out


def _wavefronts(addr: torch.Tensor) -> torch.Tensor:
    """Shared-memory wavefronts of warp-wide 32-bit loads: addr [..., 32]
    word addresses -> [...], the most distinct words any of the 32 banks
    serves (lanes that read one word share it)."""
    key = torch.sort(addr, dim=-1).values
    new = torch.ones_like(key, dtype=torch.int32)
    new[..., 1:] = (key[..., 1:] != key[..., :-1]).to(torch.int32)
    per_bank = torch.zeros(key.shape[:-1] + (32,), dtype=torch.int32,
                           device=key.device)
    per_bank.scatter_add_(-1, key % 32, new)
    return per_bank.max(-1).values


def wavefronts_per_load(variant, taps, djs, locs) -> float:
    """Mean shared-memory wavefronts of the kernel's warp-wide loads, over
    every load of a pass at every warp unit of 32 pixels of a row (all
    lanes load, as the kernel's source does)."""
    total = n = 0
    for addr in step_addresses(variant, taps, djs, locs):
        w = _wavefronts(addr.reshape(addr.shape[0], -1, WARP))
        total += int(w.sum())
        n += w.numel()
    return total / n


def sass_counts() -> dict:
    """Per variant, the kernel's pass loop (36 steps) from the SASS of the
    built library: instructions by pipe, opcodes, and the whole kernel's
    conversions."""
    _lib()
    funcs = sass.functions(sass.disassemble(_build._target(_NAME)))
    out = {}
    for i, variant in enumerate(VARIANTS):
        name = [f for f in funcs if f"gather_kernelILi{i}E" in f]
        if len(name) != 1:
            raise RuntimeError(f"gather_bench: no single SASS function for "
                               f"{variant}: {sorted(funcs)}")
        out[variant] = sass.loop_counts(funcs[name[0]])
    return out


def floor_ms(counts: dict, waves_per_load: float, units: int, sms: int,
             clock_mhz: float):
    """The floor of the work as written: the larger of the shared-memory
    wavefronts (the pass loop's loads from the SASS times
    ``waves_per_load``, one wavefront a clock an SM) and each pipe's
    instructions (lanes a clock an SM, ``sass.PIPE_LANES``) of 17 passes
    over ``units`` warp units spread over ``sms`` SMs, at ``clock_mhz``.
    Returns (ms, what sets it)."""
    per_unit = PV * units / sms
    clocks = {"shared wavefronts":
              per_unit * counts["pipes"].get("shared", 0) * waves_per_load}
    for pipe, lanes in sass.PIPE_LANES.items():
        n = counts["pipes"].get(pipe, 0)
        clocks[f"{pipe} pipe"] = per_unit * n * WARP / lanes
    by = max(clocks, key=clocks.get)
    return clocks[by] / (clock_mhz * 1e3), by


def sm_clock_mhz(fn) -> float:
    """The SM clock nvidia-smi reads while fn() is launched back to back
    (the card is busy with it for the whole query)."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits"],
                            stdout=subprocess.PIPE, text=True)
    try:
        while proc.poll() is None:
            fn()
        torch.cuda.synchronize()
        text = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return float(text.split()[0])


def floors(ins, times: dict) -> dict:
    """Per variant of ``times`` ({variant: ms}): its launch (``launch_info``),
    the SASS counts a step, the SM clock sampled under its load, and its
    floor of the work as written (ms, what sets it).  Launches the kernels
    (to load the card while the clock is sampled)."""
    taps, djs, locs, _ = ins
    counts = sass_counts()
    units = djs.numel() // WARP
    out = {}
    for variant in times:
        info = launch_info(variant, units)
        waves = wavefronts_per_load(variant, taps, djs, locs)
        clock = sm_clock_mhz(lambda: run(variant, *ins))
        ms, by = floor_ms(counts[variant], waves, units, info["sms"], clock)
        out[variant] = dict(info, counts=counts[variant], clock_mhz=clock,
                            wavefronts_per_load=waves, floor_ms=ms,
                            floor_by=by)
    return out


def report(variant, ms, f) -> str:
    """One line: time, floor and what sets it, the step's instructions by
    pipe, registers and blocks an SM."""
    p = f["counts"]["pipes"]
    per = lambda k: p.get(k, 0) / TAPS
    return (f"{variant:12s} {ms:8.4f} ms  floor {f['floor_ms']:.4f} ms "
            f"({f['floor_by']}, SM clock {f['clock_mhz']:.0f} MHz)  a step: "
            f"issue {per('issue'):.2f}, alu {per('alu'):.2f}, fp32 "
            f"{per('fp32'):.2f}, imad {per('imad'):.2f}, conv "
            f"{per('conv'):.2f}, uniform {per('uniform'):.2f}, LDS "
            f"{per('shared'):.2f} of {f['wavefronts_per_load']:.2f} "
            f"wavefronts  {f['registers']} registers, "
            f"{f['blocks_per_sm']} blocks of {f['threads']} an SM of "
            f"{f['sms']} ({f['fit_per_sm']} fit), "
            f"{f['shared_bytes']} B shared, {f['local_bytes']} B local, "
            f"conversions {f['counts']['conversions'] or 'none'}")


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
    print(empty_launch(ins[1].numel() // WARP), flush=True)
    times = {v: cuda_ms(lambda: run(v, *ins)) for v in VARIANTS}
    for variant, f in floors(ins, times).items():
        print(report(variant, times[variant], f), flush=True)
    print(f"\nquad8 {times['quad8']:.4f} ms vs p2x5 {times['p2x5']:.4f} ms "
          f"({times['quad8'] / max(times['p2x5'], 1e-9):.2f}x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
