"""Visualization writers (counterpart of ``dvpmvs/utils/viz.py``;
reference ShowDepthMap / ShowNormalMap / ShowWeakImage / ShowEdgeImage,
APD.cpp:694-840).

The pixels are JAX's.  A ``.png`` is written with ``zlib`` and ``struct``
of the standard library (8-bit RGB, no filter), so the benchmark outputs
need no image library; any other suffix (the medium results' ``.jpg``) is
encoded by PIL, as JAX does, and raises naming PIL where it is not
installed.
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


def _write_png(path: Path, rgb: np.ndarray) -> None:
    H, W, _ = rgb.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           rgb.reshape(H, W * 3)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                     + _chunk(b"IEND", b""))


def _save(path, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] image (cast to uint8 as JAX's writer casts):
    PNG through the standard library, other formats through PIL."""
    path = Path(path)
    rgb = np.ascontiguousarray(np.asarray(rgb).astype(np.uint8))
    if path.suffix.lower() == ".png":
        _write_png(path, rgb)
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: encoding {path.suffix} images needs PIL, which is not "
            f"installed; install Pillow or write .png") from e
    Image.fromarray(rgb).save(str(path))


def depth_color(depth: np.ndarray, dmin: float, dmax: float) -> np.ndarray:
    """Jet-style colormap; invalid (<=0) pixels black."""
    t = np.clip((depth - dmin) / max(dmax - dmin, 1e-12), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    rgb = np.stack([r, g, b], -1) * 255.0
    rgb[depth <= 0] = 0
    return rgb


def write_depth_viz(path, depth, dmin, dmax):
    _save(path, depth_color(np.asarray(depth), float(dmin), float(dmax)))


def write_normal_viz(path, normal_world):
    n = np.asarray(normal_world)
    rgb = np.clip((n + 1.0) * 0.5 * 255.0, 0, 255)
    _save(path, rgb)


def write_weak_viz(path, weak):
    """STRONG white, WEAK green, UNKNOWN red."""
    w = np.asarray(weak)
    rgb = np.zeros((*w.shape, 3), np.uint8)
    rgb[w == PixelState.STRONG] = (255, 255, 255)
    rgb[w == PixelState.WEAK] = (0, 255, 0)
    rgb[w == PixelState.UNKNOWN] = (255, 0, 0)
    _save(path, rgb)


def write_edge_viz(path, edge):
    e = (np.asarray(edge) > 0).astype(np.uint8) * 255
    _save(path, np.stack([e, e, e], -1))
