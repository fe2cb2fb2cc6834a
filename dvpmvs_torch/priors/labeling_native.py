"""ctypes binding of the native connected-component labeler
(``csrc/labeling.cpp``, the port's copy of ``native/labeling.cpp``), built
with the host compiler on first use by ``kernels/_build.py``.  A failed
build raises: there is no fallback."""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..kernels import _build


def _lib() -> ctypes.CDLL:
    lib = _build.host_library("labeling")
    fn = lib.label_zero_components
    fn.restype = ctypes.c_int32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_void_p]
    return lib


def label(zero_mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """zero_mask [H, W] bool (True = pixel to label) ->
    (labels int32 [H, W], counts int64 [n+1]); components are numbered
    1..n in raster order of their first pixel, 0 is the background."""
    zero_mask = np.asarray(zero_mask, bool)
    if zero_mask.ndim != 2:
        raise ValueError(f"label: expected a 2-D mask, got {zero_mask.shape}")
    h, w = zero_mask.shape
    mask = np.ascontiguousarray(~zero_mask, np.uint8)   # nonzero = background
    labels = np.zeros((h, w), np.int32)
    counts = np.zeros(h * w + 1, np.int64)
    n = _lib().label_zero_components(mask.ctypes.data, h, w,
                                     labels.ctypes.data, counts.ctypes.data)
    return labels, counts[:n + 1].copy()
