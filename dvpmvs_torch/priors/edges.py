"""Depth-edge prior, Canny edge-mask mode (counterpart of
``dvpmvs/priors/edges.py``; oracle ``EdgeSegment``, APD.cpp:348-499).

Host-side numpy/scipy, computed once per (view, round).  Only mode 0 with
Canny runs on the main path; the Roberts/Hough label mode (mode 1) waits for
the priors slice of the port (ROADMAP.md, Queue 1 item 2).
``connected_components`` is here on its scipy path, for the runner's
visibility cleanup.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def _resize_linear(img: np.ndarray, new_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize (cv::INTER_LINEAR equivalent)."""
    H, W = img.shape
    nh, nw = new_hw
    ys = (np.arange(nh) + 0.5) * H / nh - 0.5
    xs = (np.arange(nw) + 0.5) * W / nw - 0.5
    ys = np.clip(ys, 0, H - 1)
    xs = np.clip(xs, 0, W - 1)
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def canny(img: np.ndarray, threshold1: float, threshold2: float,
          l2gradient: bool = True) -> np.ndarray:
    """Canny edges (Sobel-3, NMS, hysteresis) -> uint8 {0, 255}."""
    img = img.astype(np.float32)
    k = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    gx = ndimage.convolve(img, k, mode="nearest")
    gy = ndimage.convolve(img, k.T, mode="nearest")
    if l2gradient:
        mag = np.hypot(gx, gy)
    else:
        mag = np.abs(gx) + np.abs(gy)

    # non-maximum suppression over 4 quantized directions
    ang = np.mod(np.arctan2(gy, gx), np.pi)
    q = ((ang + np.pi / 8) // (np.pi / 4)).astype(int) % 4
    H, W = img.shape
    pad = np.pad(mag, 1, mode="constant")
    offs = {0: ((0, 1), (0, -1)), 1: ((1, 1), (-1, -1)),
            2: ((1, 0), (-1, 0)), 3: ((1, -1), (-1, 1))}
    nms = np.zeros_like(mag)
    for d, ((dy1, dx1), (dy2, dx2)) in offs.items():
        n1 = pad[1 + dy1:1 + dy1 + H, 1 + dx1:1 + dx1 + W]
        n2 = pad[1 + dy2:1 + dy2 + H, 1 + dx2:1 + dx2 + W]
        keep = (q == d) & (mag >= n1) & (mag >= n2)
        nms = np.where(keep, mag, nms)

    lo, hi = min(threshold1, threshold2), max(threshold1, threshold2)
    strong = nms > hi
    weak = nms > lo
    # hysteresis: weak pixels connected (8-conn) to strong survive
    lbl, n = ndimage.label(weak, structure=np.ones((3, 3), int))
    if n:
        strong_labels = np.unique(lbl[strong])
        strong_labels = strong_labels[strong_labels != 0]
        keep = np.isin(lbl, strong_labels)
    else:
        keep = strong
    return np.where(keep, 255, 0).astype(np.uint8)


def edge_segment(scale: int, src_image: np.ndarray, mode: int = 0,
                 use_canny: bool = True) -> np.ndarray:
    """Reference ``EdgeSegment`` in mode 0 with Canny -> uint8 0/255 edge
    mask at the image size, with the reference's border fix-up."""
    if mode != 0 or not use_canny:
        raise NotImplementedError(
            "only the Canny edge mask (mode 0) is ported; the label mode "
            "waits for the priors slice of the port")
    src_image = np.asarray(src_image)
    if src_image.dtype != np.uint8:
        src_image = np.clip(src_image, 0, 255).astype(np.uint8)
    H, W = src_image.shape
    robthr = 4

    median_val = int(np.median(src_image))
    sigma = 0.67
    dst = canny(src_image, (1 - sigma) * median_val, median_val,
                l2gradient=True)
    dst = _resize_linear(dst.astype(np.float32), (H, W))
    dst = np.where(dst > robthr, 255, 0).astype(np.uint8)

    # border fix-up (APD.cpp:453-464): borders copy their inner neighbor's
    # non-edge status
    dst[:, 0] = np.where(dst[:, 1] == 0, 0, dst[:, 0])
    dst[:, -1] = np.where(dst[:, -2] == 0, 0, dst[:, -1])
    dst[0, :] = np.where(dst[1, :] == 0, 0, dst[0, :])
    dst[-1, :] = np.where(dst[-2, :] == 0, 0, dst[-1, :])
    return dst


def connected_components(nonedge: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4-connected labeling of ZERO (non-edge) pixels + per-label counts.

    Matches ``Connect`` + ``Label_Update`` (APD.cpp:233-346, 138-230):
    label 0 = edge pixels; labels 1..N = components.  The scipy path of
    ``dvpmvs.priors.edges.connected_components``; its native union-find
    labeler waits for ROADMAP.md Queue 1 item 2.
    """
    zero = np.asarray(nonedge) == 0
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], int)
    lab, n = ndimage.label(zero, structure=structure)
    counts = np.bincount(lab.ravel(), minlength=n + 1)
    counts[0] = 0
    return lab.astype(np.int32), counts.astype(np.int64)
