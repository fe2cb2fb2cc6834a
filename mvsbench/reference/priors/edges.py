"""Depth-edge prior: edge maps and segmentation labels (counterpart of
``dvpmvs/priors/edges.py``).

Oracle: ``EdgeSegment`` (APD.cpp:348-499), two modes:
  * edge mask (use_canny): Canny with median-derived thresholds
    (t1 = (1-0.67)*median, t2 = median), computed at half resolution and
    resized back to full size;
  * label mask: Roberts-cross gradients at quarter resolution, threshold 4,
    connected components of the non-edge regions, probabilistic-Hough
    completion of large weak regions' boundaries, then component labeling at
    the working scale with small regions suppressed to -1.

Host-side numpy/scipy, computed once per (view, round) and cached by the
scene runner.  Connected components come from scipy's labeling (the port
runs a native union-find labeler that gives the same labels).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy import ndimage

_ROBERTS_BORDER = 50.0 * math.sqrt(2.0)
_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], int)


def roberts(img: np.ndarray) -> np.ndarray:
    """2x2 Roberts-cross gradient magnitude (APD.cpp:120-136)."""
    img = img.astype(np.float32)
    g1 = img[:-1, :-1] - img[1:, 1:]
    g2 = img[:-1, 1:] - img[1:, :-1]
    out = np.full(img.shape, _ROBERTS_BORDER, np.float32)
    out[:-1, :-1] = np.hypot(g1, g2)
    return out


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


def connected_components(nonedge: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4-connected labeling of ZERO (non-edge) pixels + per-label counts.

    Matches ``Connect`` + ``Label_Update`` (APD.cpp:233-346, 138-230):
    label 0 = edge pixels; labels 1..N = components, numbered in raster
    order of their first pixel, by ``scipy.ndimage.label``."""
    zero = np.asarray(nonedge) == 0
    lab, n = ndimage.label(zero, structure=_CROSS)
    counts = np.bincount(lab.ravel(), minlength=n + 1)
    counts[0] = 0
    return lab.astype(np.int32), counts.astype(np.int64)


def hough_complete(edge: np.ndarray, labels: np.ndarray,
                   counts: np.ndarray, weak_tex_num: int,
                   thr: int, min_len: int, max_gap: int) -> np.ndarray:
    """Complete large weak regions' boundaries with straight lines.

    For each big component, build its one-pixel outer boundary and run a
    probabilistic-Hough-style completion: strong (theta, rho) lines are
    detected on the boundary image and their covered runs (allowing gaps up
    to ``max_gap``, length >= ``min_len``) are drawn into the edge map
    (APD.cpp:374-401 behavior).
    """
    H, W = edge.shape
    out = edge.copy()
    big = [k for k in range(1, len(counts)) if counts[k] >= weak_tex_num]
    for k in big:
        region = labels == k
        # one-pixel outer boundary (4-neighborhood)
        dil = ndimage.binary_dilation(region, structure=_CROSS.astype(bool))
        boundary = dil & ~region
        ys, xs = np.nonzero(boundary)
        if len(ys) < thr:
            continue
        # Hough accumulator
        thetas = np.deg2rad(np.arange(0, 180))
        diag = int(np.ceil(np.hypot(H, W)))
        cos_t = np.cos(thetas)
        sin_t = np.sin(thetas)
        rho = np.round(xs[:, None] * cos_t[None] + ys[:, None] * sin_t[None]
                       ).astype(int) + diag
        acc = np.zeros((2 * diag + 1, len(thetas)), np.int32)
        np.add.at(acc, (rho.ravel(),
                        np.tile(np.arange(len(thetas)), len(ys))), 1)
        peaks = np.argwhere(acc >= thr)
        # strongest few lines only
        if len(peaks) == 0:
            continue
        vals = acc[peaks[:, 0], peaks[:, 1]]
        # the default sort kind, as JAX's copy: the order among equal
        # accumulator cells is not stable across sort kinds
        order = np.argsort(-vals)[:8]
        for pi in order:
            r_idx, t_idx = peaks[pi]
            r = r_idx - diag
            ct, st = cos_t[t_idx], sin_t[t_idx]
            # points near this line
            d = np.abs(xs * ct + ys * st - r)
            on = d < 1.5
            if on.sum() < min_len:
                continue
            # parametrize along the line, find dense runs
            t = -xs[on] * st + ys[on] * ct
            t_sorted = np.sort(t)
            gaps = np.diff(t_sorted)
            run_start = 0
            for i in range(len(t_sorted)):
                end_run = (i == len(t_sorted) - 1) or (gaps[i] > max_gap)
                if end_run:
                    if t_sorted[i] - t_sorted[run_start] >= min_len:
                        _draw_line(out, r, ct, st,
                                   t_sorted[run_start], t_sorted[i])
                    run_start = i + 1
    return out


def _draw_line(img, r, ct, st, t0, t1):
    n = int(np.ceil(t1 - t0)) + 1
    ts = np.linspace(t0, t1, max(n, 2))
    xs = np.round(r * ct - ts * st).astype(int)
    ys = np.round(r * st + ts * ct).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = 255


def edge_segment(scale: int, src_image: np.ndarray, mode: int,
                 use_canny: bool = False) -> np.ndarray:
    """Reference ``EdgeSegment``: mode 0 -> edge mask (uint8 0/255),
    mode 1 -> int32 label mask (-1 = suppressed small region, 0 = edges)."""
    src_image = np.asarray(src_image)
    if src_image.dtype != np.uint8:
        src_image = np.clip(src_image, 0, 255).astype(np.uint8)
    H, W = src_image.shape
    robthr = 4
    weak_tex_num = int(H * W / (1024 << scale << scale))

    if not use_canny:
        src_down = _resize_linear(src_image.astype(np.float32),
                                  (H // 2, W // 2))
        src_down = _resize_linear(src_down, (H // 4, W // 4))
        hough_param = int(min(src_down.shape) / 30.0)
        dst = roberts(src_down)
        dst = np.where(dst > robthr, 255, 0).astype(np.uint8)
        lab0, cnt0 = connected_components(dst)
        dst = hough_complete(dst, lab0, cnt0, weak_tex_num,
                             max(hough_param, 1), max(hough_param, 1),
                             max(hough_param, 1))
    else:
        median_val = int(np.median(src_image))
        sigma = 0.67
        dst = canny(src_image, (1 - sigma) * median_val, median_val,
                    l2gradient=True)

    if mode == 0:
        dst = _resize_linear(dst.astype(np.float32), (H, W))
    else:
        factor = 1.0 / (1 << scale)
        nh, nw = round(H * factor), round(W * factor)
        dst = _resize_linear(dst.astype(np.float32), (nh, nw))
    dst = np.where(dst > robthr, 255, 0).astype(np.uint8)

    # border fix-up (APD.cpp:453-464): borders copy their inner neighbor's
    # non-edge status
    dst[:, 0] = np.where(dst[:, 1] == 0, 0, dst[:, 0])
    dst[:, -1] = np.where(dst[:, -2] == 0, 0, dst[:, -1])
    dst[0, :] = np.where(dst[1, :] == 0, 0, dst[0, :])
    dst[-1, :] = np.where(dst[-2, :] == 0, 0, dst[-1, :])

    if mode == 0:
        return dst

    lab, cnt = connected_components(dst)
    small = (cnt[lab] <= weak_tex_num) & (lab != 0)
    lab[small] = -1
    return lab
