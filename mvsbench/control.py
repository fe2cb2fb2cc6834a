"""The control of the comparison, and the readings its limits are set from.

The control is the reference put in the program's place with every cost
kernel (K1 ``fused_ncc_costs``, K2 ``sweep_weighted_ncc``, K3 ``geom_cost``,
K4 ``anchor_slot_costs``, the warp NCC ``warp_ncc``) reading its float
inputs and writing its float outputs in bfloat16, the step below the
configuration's float32 that would tempt a change (half the bytes); the
arithmetic between the roundings stays float32.  TF32 is no step below here:
the pass holds no matrix product (its 3x3 products are elementwise), so
allowing TF32 leaves every bit as it is.

    python3 -m mvsbench.control --workload <cell> --seeds <n> [<n> ...]

runs, for each seed, the control of the stage the cell drives
(``stages/<stage>.py``, ``control``); the view pass's runs the cell's
set-up and one window pass of each kind, then the reference and the
control on those passes.  It prints one JSON line a seed: the program's
numbers (its sound readings) and the control's.  It needs the card, like
a run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

from . import cells as cells_mod
from . import run
from .trace import KERNEL_ENTRIES


def _bf16(torch, x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    if hasattr(x, "_fields"):                      # NamedTuple results
        return type(x)(*(_bf16(torch, y) for y in x))
    return x


def _rounded(torch, fn):
    def wrapper(*args, **kwargs):
        args = [_bf16(torch, a) for a in args]
        kwargs = {k: _bf16(torch, v) for k, v in kwargs.items()}
        return _bf16(torch, fn(*args, **kwargs))
    return wrapper


@contextlib.contextmanager
def bf16_kernels(torch):
    """The reference's cost kernels in bfloat16 storage, for the block."""
    import importlib

    patched = []
    originals = {}
    for mod_name, fn in KERNEL_ENTRIES.items():
        mod = importlib.import_module(f"mvsbench.reference.kernels.{mod_name}")
        originals[fn] = getattr(mod, fn)
    try:
        for name, mod in list(sys.modules.items()):
            if mod is None or not name.startswith("mvsbench.reference"):
                continue
            for attr, val in list(vars(mod).items()):
                for fn, original in originals.items():
                    if val is original:
                        patched.append((mod, attr, val))
                        setattr(mod, attr, _rounded(torch, original))
        yield
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def readings(torch, cell, seed: int, card) -> dict:
    """The program's and the control's numbers on one seed's passes: the
    ``control`` of the stage the cell's traffic drives."""
    stage = cells_mod.stage_module(cell)
    if not hasattr(stage, "control"):
        raise SystemExit(f"mvsbench.control: stage {stage.__name__} has "
                         f"no control")
    return stage.control(torch, cell, seed, card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mvsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = cells_mod.load_cell(Path.cwd(), args.workload)

    import torch

    if not torch.cuda.is_available():
        print("mvsbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    card = run.Card(torch, torch.device("cuda", 0))
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name,
                          **readings(torch, cell, seed, card)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
