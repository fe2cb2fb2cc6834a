"""Adaptive checkerboard propagation: candidate pre-selection and
multi-hypothesis joint view selection (counterpart of
``dvpmvs/kernels/propagation.py``; oracle ``CheckerboardPropagationStrong``,
APD.cu:2038-2560).

Both branches are here: the ACMM-style scan with extended far propagation
(``select_candidates`` + ``judge_extend``) and the edge-adaptive dual scan
(``select_candidates_edge`` + ``edge_candidate_merge``) that runs whenever an
edge map exists.  Every group member is a static image shift; the reference
quirks fixed by dvpmvs stay fixed (invalid directions enter MHJVS with cost 2;
the adopted candidate is the group's pre-selected plane).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from .. import fmath
from .ncc import COST_MAX


def _vsweep(x0: int, y0: int, first_axis: str, sx: int, sy: int
            ) -> List[Tuple[int, int]]:
    out = [(x0, y0)]
    x, y = x0, y0
    for i in range(7):
        if (i % 2 == 0) == (first_axis == "x"):
            x += 2 * sx
        else:
            y += 2 * sy
        out.append((x, y))
    return out


# Candidate offsets (dx, dy) per direction group, first entry = base
# (APD.cu:2146-2460).
DIRECTIONS: List[List[Tuple[int, int]]] = [
    _vsweep(-5, -6, "x", -1, -1),                       # 0 left_up
    [(0, -5), (0, -7), (0, -9), (0, -11), (0, -13)],    # 1 up_far
    _vsweep(6, -5, "y", 1, -1),                         # 2 right_up
    [(0, 5), (0, 7), (0, 9), (0, 11), (0, 13)],         # 3 down_far
    _vsweep(5, 6, "x", 1, 1),                           # 4 right_down
    [(-5, 0), (-7, 0), (-9, 0), (-11, 0), (-13, 0)],    # 5 left_far
    _vsweep(-6, 5, "y", -1, 1),                         # 6 left_down
    [(5, 0), (7, 0), (9, 0), (11, 0), (13, 0)],         # 7 right_far
]

PRIOR_FLAG_INDEX = (0, 2, 4, 6)
PRIOR_NEIGHBOR_OFFSETS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def shift_map(arr: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[y, x] = arr[y + dy, x + dx] (wrapping; mask with in_bounds)."""
    return torch.roll(arr, shifts=(-dy, -dx), dims=(0, 1))


def _in_bounds_mask(H: int, W: int, dx: int, dy: int, device,
                    rows=None) -> torch.Tensor:
    """Whether pixel (x + dx, y + dy) lies in the H x W image, for every
    pixel, or for the compute rows of ``rows`` (an ``engine.rows.RowWindow``
    of an H-row image): the image's bounds, not the window's."""
    xs = torch.arange(W, device=device)[None, :]
    ys = (torch.arange(H, device=device) if rows is None
          else rows.row_ids(device))[:, None]
    return ((xs + dx >= 0) & (xs + dx < W) & (ys + dy >= 0) & (ys + dy < H))


def shift_rows(arr: torch.Tensor, dx: int, dy: int, rows=None
               ) -> torch.Tensor:
    """``shift_map(arr, dx, dy)`` on the compute rows of ``rows`` only (all
    rows without): out[i, x] = arr[(y_i + dy) mod H, (x + dx) mod W] for
    the image row y_i of compute row i."""
    if rows is None:
        return shift_map(arr, dx, dy)
    idx = torch.remainder(rows.row_ids(arr.device) + dy, arr.shape[0])
    return torch.roll(arr.index_select(0, idx), shifts=-dx, dims=1)


def _extended_offsets(offsets: List[Tuple[int, int]], ext_round: int
                      ) -> List[Tuple[int, int]]:
    """Offsets of extension round ``ext_round`` (APD.cu:1392, 1624-1625)."""
    push = (10 if len(offsets) == 5 else 8) * ext_round
    return [(x + int(np.sign(x)) * push, y + int(np.sign(y)) * push)
            for (x, y) in offsets]


def select_candidates(plane, cost, ray, strong_ok=None, extend_round=-1,
                      rows=None):
    """Pre-select the best candidate plane per direction by cost-map scan.

    Returns (cand_planes [8, H, W, 4], flags [8, H, W], map_costs
    [8, H, W]); with ``rows`` (an ``engine.rows.RowWindow``) those of its
    compute rows, read from the whole fields."""
    H, W = cost.shape
    dev = cost.device
    shift = lambda a, dx, dy: shift_rows(a, dx, dy, rows)
    if rows is not None:
        ray = rows.take(ray)
    inf = torch.full(ray.shape[:2], float("inf"), dtype=cost.dtype,
                     device=dev)
    cand_planes, flags, map_costs = [], [], []
    for offsets in DIRECTIONS:
        if extend_round >= 0:
            offsets = _extended_offsets(offsets, extend_round)
        bx, by = offsets[0]
        base_ok = _in_bounds_mask(H, W, bx, by, dev, rows)
        if strong_ok is not None:
            base_ok = base_ok & shift(strong_ok, bx, by)
        best_cost = torch.where(base_ok, shift(cost, bx, by), inf)
        best_plane = shift(plane, bx, by)
        for (ox, oy) in offsets[1:]:
            ok = _in_bounds_mask(H, W, ox, oy, dev, rows)
            if strong_ok is not None:
                ok = ok & shift(strong_ok, ox, oy)
            c = shift(cost, ox, oy)
            pl = shift(plane, ox, oy)
            facing = torch.sum(pl[..., :3] * ray, dim=-1) <= 0.0
            better = ok & facing & (c < best_cost)
            best_cost = torch.where(better, c, best_cost)
            best_plane = torch.where(better[..., None], pl, best_plane)
        cand_planes.append(best_plane)
        flags.append(base_ok)
        map_costs.append(best_cost)
    return torch.stack(cand_planes), torch.stack(flags), torch.stack(map_costs)


# Edge-adaptive strong propagation (the use_edge branch, APD.cu:2038-2140).
EDGE_DIRS = ((0, -1), (0, 1), (-1, 0), (1, 0),
             (-1, -1), (1, 1), (-1, 1), (1, -1))

# Per-direction extra pixel nudge (APD.cu:2070-2072, reference quirk kept).
_EDGE_NUDGE = ((0, 0), (0, 0), (0, 0), (0, 0),
               (0, 0), (1, 0), (0, 1), (1, 0))


def edge_step_lengths(H: int, W: int, diag: bool) -> list:
    """Statically possible step_len values for an image extent."""
    cap = max(H, W) / 30.0
    if diag:
        cap /= math.sqrt(2.0)
    lmax = max(2, int(cap / 22))
    if diag:
        return list(range(2, lmax + 1))
    return [2] + [l for l in range(4, lmax + 1, 2)]


def _first_min_idx(work: torch.Tensor) -> torch.Tensor:
    """First index of the minimum along axis 0 (strict-< running min)."""
    m = torch.min(work, dim=0).values
    kio = torch.arange(work.shape[0], device=work.device).reshape(
        (-1,) + (1,) * (work.dim() - 1))
    return torch.min(torch.where(work == m[None], kio,
                                 torch.full_like(kio, work.shape[0])),
                     dim=0).values


def _take_shifted(plane: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                  rows=None) -> torch.Tensor:
    """plane[(y + oy) mod H, (x + ox) mod W] for per-pixel offsets (on the
    compute rows of ``rows``: ox, oy and the result on them)."""
    H, W = plane.shape[:2]
    ys = (torch.arange(H, device=plane.device) if rows is None
          else rows.row_ids(plane.device))[:, None]
    xs = torch.arange(W, device=plane.device)[None, :]
    flat = torch.remainder(ys + oy, H) * W + torch.remainder(xs + ox, W)
    return plane.reshape(H * W, -1)[flat.reshape(-1)].reshape(
        flat.shape + plane.shape[2:])


def select_candidates_edge(plane, cost, edge, edge_dist, rows=None):
    """Edge-adaptive candidate pre-selection (APD.cu:2038-2140).

    Returns (cand1 [8, H, W, 4], flags1 [8, H, W], cand2, flags2,
    differs [8, H, W]); with ``rows`` (an ``engine.rows.RowWindow``) those
    of its compute rows, read from the whole fields."""
    H, W = cost.shape
    dev = cost.device
    take = (lambda a: a) if rows is None else rows.take
    edge = take(edge)
    sq2 = math.sqrt(2.0)
    max_d = max(H, W) / 30.0
    s_max = min(22, max(11, int(max_d * 0.5)))

    cand1, flags1, cand2, flags2, differs = [], [], [], [], []
    for d, (dx, dy) in enumerate(EDGE_DIRS):
        diag = d >= 4
        fx, fy = _EDGE_NUDGE[d]
        # per-pixel steps-to-edge along this ray (APD.cu:2054-2062)
        ed = take(edge_dist[d])
        dist = ed / (sq2 if diag else 1.0)
        nohit = ed >= 1e8
        cap = max_d / (sq2 if diag else 1.0)
        dist = torch.where(nohit | (dist >= max_d),
                           torch.full_like(dist, cap), dist)
        dist = torch.where(edge, torch.full_like(dist, 22.0), dist)
        step_num = torch.clamp((dist * 0.5).to(torch.int32), 11, 22)
        step_len = torch.clamp(
            (dist / step_num.to(torch.float32)).to(torch.int32), min=2)
        if not diag:
            step_len = step_len - step_len % 2

        Ls = edge_step_lengths(H, W, diag)
        cands, oks, oxs, oys, short_rows = [], [], [], [], []
        for L in Ls:
            sel_L = step_len == L
            for s in range(s_max):
                ox = 5 * dx + s * L * dx + fx
                oy = 5 * dy + s * L * dy + fy
                inb = _in_bounds_mask(H, W, ox, oy, dev, rows)
                if L == 2 and s < 11:
                    short_rows.append(len(cands))
                cands.append(shift_rows(cost, ox, oy, rows))
                oks.append(sel_L & inb & (s < step_num))
                oxs.append(ox)
                oys.append(oy)
        cstack = torch.stack(cands)                       # [S, H, W]
        ok1 = torch.stack(oks)
        S = len(cands)
        inf = torch.full_like(cstack, float("inf"))
        ox_t = torch.as_tensor(oxs, device=dev)
        oy_t = torch.as_tensor(oys, device=dev)

        arg1 = torch.clamp(_first_min_idx(torch.where(ok1, cstack, inf)),
                           0, S - 1)
        got1 = torch.any(ok1, dim=0)

        srows = torch.as_tensor(short_rows, device=dev)
        ok2 = torch.stack([_in_bounds_mask(H, W, oxs[i], oys[i], dev, rows)
                           for i in short_rows])
        arg2 = torch.clamp(_first_min_idx(torch.where(ok2, cstack[srows],
                                                      inf[srows])),
                           0, len(short_rows) - 1)
        got2 = torch.any(ok2, dim=0)
        row2 = srows[arg2]

        o1x, o1y = ox_t[arg1], oy_t[arg1]
        o2x, o2y = ox_t[row2], oy_t[row2]
        cand1.append(_take_shifted(plane, o1x, o1y, rows))
        cand2.append(_take_shifted(plane, o2x, o2y, rows))
        flags1.append(got1)
        flags2.append(got2)
        differs.append(got1 & got2 & ((o1y * W + o1x) != (o2y * W + o2x)))
    return (torch.stack(cand1), torch.stack(flags1),
            torch.stack(cand2), torch.stack(flags2), torch.stack(differs))


def edge_candidate_merge(edge, flags1, flags2, differs, ca1, ca2, cand1,
                         cand2, iter_idx):
    """Good/bad-view-count comparison of the two scans (APD.cu:2090-2140).
    Returns (cost_array [8, H, W, V], cand [8, H, W, 4], flags [8, H, W])."""
    good_thr = _good_threshold(iter_idx)
    ca2 = torch.where(differs[..., None], ca2, ca1)
    good1 = torch.sum(ca1 < good_thr, dim=-1)
    bad1 = torch.sum(ca1 > 1.2, dim=-1)
    good2 = torch.sum(ca2 < good_thr, dim=-1)
    bad2 = torch.sum(ca2 > 1.2, dim=-1)
    replace = (~edge[None]) & flags2 & (
        ~flags1 | (good2 > good1) | ((good2 == good1) & (bad2 < bad1)))
    cost_array = torch.where(replace[..., None], ca2, ca1)
    cand = torch.where(replace[..., None], cand2, cand1)
    flags = flags1 | (flags2 & ~edge[None])
    return cost_array, cand, flags


def _good_threshold(iter_idx, scale: float = 1.0) -> float:
    """0.8 exp(-it^2 scale / 90) in float32, as the JAX package computes it."""
    it = np.float32(iter_idx)
    return float(np.float32(0.8) * np.exp(
        np.float32(it * it * np.float32(scale)) / np.float32(-90.0),
        dtype=np.float32))


def judge_extend(iter_idx, ext_round: int, cost_array, flags):
    """Per-(dir, pixel) gate for extended propagation (JudgeExtend,
    APD.cu:1872-1896): extend while the candidate is still BAD."""
    good_thr = _good_threshold(iter_idx, 3.0 - ext_round)
    good = torch.sum(cost_array < good_thr, dim=-1)
    bad = torch.sum(cost_array > 1.2, dim=-1)
    return flags & ~((good >= 1) & (bad <= 2))


def neighbor_prior(sel_views, flags, rows=None):
    """Strong-pass view-selection prior from the 4 direct neighbors'
    selected-view sets, gated by flag[2i] (APD.cu:2468-2480); with
    ``rows`` on its compute rows (``flags`` on them, ``sel_views``
    whole)."""
    prior = torch.zeros(flags.shape[1:] + sel_views.shape[2:],
                        dtype=torch.float32, device=sel_views.device)
    for (ox, oy), fidx in zip(PRIOR_NEIGHBOR_OFFSETS, PRIOR_FLAG_INDEX):
        nb = shift_rows(sel_views.to(torch.float32), ox, oy, rows)
        gate = flags[fidx][..., None].to(torch.float32)
        prior = prior + gate * torch.where(nb > 0, 0.9, 0.1)
    return prior


def mhjvs(r: torch.Tensor, cost_array, flags, prior, iter_idx):
    """Multi-hypothesis joint view selection (APD.cu:2462-2541).

    ``r`` [S, H, W, 1] are the Monte-Carlo uniforms (drawn by the caller).
    Returns (view_weights [H, W, V], temp_selected [H, W, V] bool,
    weight_norm [H, W])."""
    D, H, W, V = cost_array.shape
    ca = torch.where(flags[..., None], cost_array,
                     torch.full_like(cost_array, COST_MAX))
    cost_threshold = _good_threshold(iter_idx)
    below = ca < cost_threshold
    count = torch.sum(below, dim=0).to(torch.float32)
    count_false = torch.sum(ca > 1.2, dim=0)
    tmpw = torch.sum(torch.where(below, fmath.exp(ca * ca / -0.18),
                                 torch.zeros_like(ca)), dim=0)
    fallback = float(np.exp(np.float32(cost_threshold * cost_threshold)
                            / np.float32(-0.32), dtype=np.float32))
    probs = torch.where(
        (count > 2) & (count_false < 3),
        tmpw / torch.clamp(count, min=1.0),
        torch.where(count_false < 3, torch.full_like(tmpw, fallback),
                    torch.zeros_like(tmpw)))
    probs = probs * prior

    total = torch.sum(probs, dim=-1, keepdim=True)
    cdf = torch.cumsum(probs, dim=-1) / torch.clamp(total, min=1e-30)
    cdf = torch.where(total > 0, cdf, torch.zeros_like(cdf))
    idx = torch.sum(cdf[None] <= r, dim=-1)                  # [S, H, W]
    views = torch.arange(V, device=idx.device)
    view_weights = torch.sum((idx[..., None] == views).to(torch.float32),
                             dim=0)
    temp_selected = view_weights > 0
    weight_norm = torch.sum(view_weights, dim=-1)
    return view_weights, temp_selected, weight_norm


def weighted_cost(cost_vec, view_weights, weight_norm):
    """Combine per-view costs with MC view weights -> [.., H, W]."""
    num = torch.sum(cost_vec * view_weights, dim=-1)
    return torch.where(weight_norm > 0,
                       num / torch.clamp(weight_norm, min=1e-30),
                       torch.full_like(num, COST_MAX))
