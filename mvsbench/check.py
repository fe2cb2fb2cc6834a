"""The comparison that decides ``correct``.

A view pass answers, for every pixel of the view, a depth, a world normal,
a weak / strong class, a set of selected source views (cleaned of small
islands) and an NCC radius: the state ``SceneRunner.run_view_pass`` leaves.
The reference (``reference/``, plain PyTorch on the same card) makes the
same pass from the same inputs and the same draws; PatchMatch is chaotic,
so a pass whose arithmetic rounds differently anywhere (a lower precision, a
skipped step, a different view set) ends far from the reference at many
pixels.  Two numbers are compared for each pass that is checked:

  mismatch_px     pixels at which any of the five fields differs from the
                  reference's, bit for bit
  depth_off_share share of the pixels whose depth is more than 1 % from
                  the reference's

Each has a limit of its own (``LIMITS``), set from the readings recorded in
PERF.md.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

FIELDS = ("depth", "normal_world", "weak", "sel_views", "radius")
LIMITS = {"mismatch_px": 0.0, "depth_off_share": 0.01}


def _differs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[H, W] True where the field differs at a pixel (NaN equals NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        d = ~((a == b) | (np.isnan(a) & np.isnan(b)))
    else:
        d = a != b
    return d.reshape(d.shape[0], d.shape[1], -1).any(-1)


def numbers(got, want) -> Dict[str, float]:
    """The compared numbers of one pass: the program's state ``got`` against
    the reference's ``want`` (objects with the five fields)."""
    shape = np.shape(want.depth)
    off = np.zeros(shape, bool)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if np.shape(g) != np.shape(w):
            off[:] = True
            break
        off |= _differs(g, w)
    dg = np.asarray(got.depth, np.float64)
    dw = np.asarray(want.depth, np.float64)
    if dg.shape == dw.shape:
        rel = np.abs(dg - dw) / np.maximum(np.abs(dw), 1e-12)
        depth_off = ~(rel <= 0.01)
    else:
        depth_off = np.ones(shape, bool)
    return {"mismatch_px": float(off.sum()),
            "depth_off_share": float(depth_off.mean())}


def verdict(nums: Dict[str, float]) -> bool:
    return all(nums[k] <= lim for k, lim in LIMITS.items())
