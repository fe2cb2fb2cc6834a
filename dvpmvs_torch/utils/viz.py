"""Visualization writers (counterpart of ``dvpmvs/utils/viz.py``;
reference ShowWeakImage, APD.cpp:694-840).

Only the weak-state image of the benchmark outputs is ported.  The PNG is
written with ``zlib`` and ``struct`` of the standard library (8-bit RGB,
no filter), so no image library is needed; the pixels are those PIL
writes for the JAX package.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..config import PixelState


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _save(path, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 image as an RGB PNG."""
    path = Path(path)
    if path.suffix.lower() != ".png":
        raise ValueError(f"{path}: the port writes PNG images only")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    H, W, _ = rgb.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           rgb.reshape(H, W * 3)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                     + _chunk(b"IEND", b""))


def write_weak_viz(path, weak):
    """STRONG white, WEAK green, UNKNOWN red."""
    w = np.asarray(weak)
    rgb = np.zeros((*w.shape, 3), np.uint8)
    rgb[w == PixelState.STRONG] = (255, 255, 255)
    rgb[w == PixelState.WEAK] = (0, 255, 0)
    rgb[w == PixelState.UNKNOWN] = (255, 0, 0)
    _save(path, rgb)
