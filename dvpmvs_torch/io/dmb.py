"""Binary matrix containers, byte-compatible with the reference (a copy of
``dvpmvs/io/dmb.py``, numpy only; the same bytes).

Two flavors exist in the reference:
  * versioned container (``ReadBinMat``/``WriteBinMat``, APD.cpp:548-649):
    header int32 [version=1, rows, cols, cv_type] + raw row-major data.
    Used for all inter-pass state (depths.dmb, weak.bin, selected_views.bin,
    radius.bin, edges_{s}.dmb, ...).
  * MVS-benchmark ``.dmb`` (``writeDepthDmb``/``writeNormalDmb``,
    APD.cpp:575-628): header int32 [type=1, h, w, nb] + float32 data.
    Used for depths_geom.dmb / normals.dmb outputs and the dep/ prior inputs.
"""

from __future__ import annotations

import struct as _struct
from pathlib import Path
from typing import Union

import numpy as np

_PathLike = Union[str, Path]

# OpenCV type codes: cv_type = depth + (channels - 1) * 8
_CV_DEPTH_TO_NP = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
                   4: np.int32, 5: np.float32, 6: np.float64}
_NP_TO_CV_DEPTH = {np.dtype(v): k for k, v in _CV_DEPTH_TO_NP.items()}


def _cv_type(arr: np.ndarray) -> int:
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    depth = _NP_TO_CV_DEPTH[np.dtype(arr.dtype)]
    return depth + (channels - 1) * 8


def read_bin_mat(path: _PathLike) -> np.ndarray:
    """Read a versioned binary matrix (reference ``ReadBinMat``)."""
    with open(path, "rb") as f:
        version, rows, cols, cv_type = _struct.unpack("<4i", f.read(16))
        if version != 1:
            raise ValueError(f"{path}: unsupported bin-mat version {version}")
        depth = cv_type & 7
        channels = (cv_type >> 3) + 1
        dtype = _CV_DEPTH_TO_NP[depth]
        data = np.frombuffer(f.read(), dtype=dtype,
                             count=rows * cols * channels)
    arr = data.reshape(rows, cols, channels)
    return arr[..., 0] if channels == 1 else arr


def write_bin_mat(path: _PathLike, arr: np.ndarray) -> None:
    """Write a versioned binary matrix (reference ``WriteBinMat``)."""
    arr = np.ascontiguousarray(arr)
    rows, cols = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(_struct.pack("<4i", 1, rows, cols, _cv_type(arr)))
        f.write(arr.tobytes())


def read_dmb(path: _PathLike) -> np.ndarray:
    """Read an MVS-benchmark ``.dmb`` (float32; nb=1 -> [H,W], nb>1 -> [H,W,nb])."""
    with open(path, "rb") as f:
        ftype, h, w, nb = _struct.unpack("<4i", f.read(16))
        if ftype != 1:
            raise ValueError(f"{path}: unsupported dmb type {ftype}")
        data = np.frombuffer(f.read(), dtype=np.float32, count=h * w * nb)
    return data.reshape(h, w) if nb == 1 else data.reshape(h, w, nb)


def write_depth_dmb(path: _PathLike, depth: np.ndarray) -> None:
    """Write a single-channel float ``.dmb`` (reference ``writeDepthDmb``)."""
    depth = np.ascontiguousarray(depth, dtype=np.float32)
    h, w = depth.shape
    with open(path, "wb") as f:
        f.write(_struct.pack("<4i", 1, h, w, 1))
        f.write(depth.tobytes())


def write_normal_dmb(path: _PathLike, normal: np.ndarray) -> None:
    """Write a 3-channel float ``.dmb`` (reference ``writeNormalDmb``)."""
    normal = np.ascontiguousarray(normal, dtype=np.float32)
    h, w, nb = normal.shape
    with open(path, "wb") as f:
        f.write(_struct.pack("<4i", 1, h, w, nb))
        f.write(normal.tobytes())
