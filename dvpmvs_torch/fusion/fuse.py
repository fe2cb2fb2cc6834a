"""Cross-view consistency filtering and point-cloud fusion (counterpart of
``dvpmvs/fusion/fuse.py``, its serial path).

Oracles: ``RunFusion`` (ETH3D, APD.cpp:1809-1960),
``RunFusion_TAT_Intermediate`` (APD.cpp:1962-2130),
``RunFusion_TAT_advanced`` (APD.cpp:2132-2279).

Per reference view, each pixel is projected into every source view; a source
pixel supports it when the forward-backward reprojection error, relative
depth difference and normal angle pass the variant's thresholds:
  * eth3d: err < 2 px, rdd < 0.01, angle < 10 deg; accept when the dynamic
    consistency sum(exp(-(err + 200 rdd + 10 angle))) exceeds 0.45*n for
    WEAK pixels / 0.3*n otherwise;
  * tat_intermediate: accept at the smallest k in [2, n] with >= k views
    satisfying err < 0.25k, rdd < k/3500, angle < 3k + 4 deg;
  * tat_advanced: like intermediate with rdd < k/3000 and no angle test.

The per-(ref, src) geometric tests (``_pair_consistency``) are plain
PyTorch ops on the device.  ``run_fusion`` runs them one pair at a time and
the greedy consumed-pixel masking as a host-sequential numpy loop over
reference views in ``problems`` order, as in the reference (the masks are
the only cross-view mutable state).  ``run_fusion_sharded`` computes every
pair at once (``_all_pairs_consistency``), split over the ranks of a
process group by reference view, and replaces the greedy masks by a
deterministic ownership rule.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import fmath, resolve_device
from ..config import PixelState
from ..geometry.camera import Camera, stack_cameras
from ..io.ply import write_ply


@dataclasses.dataclass
class FusionInputs:
    """Per-view fusion inputs keyed by image id."""

    images: Dict[int, np.ndarray]       # [H, W, 3] uint8 RGB (or gray x3)
    cameras: Dict[int, Camera]          # at depth-map resolution
    depths: Dict[int, np.ndarray]       # [H, W] float32
    normals: Dict[int, np.ndarray]      # [H, W, 3] world normals
    weaks: Dict[int, np.ndarray]        # [H, W] int8 PixelState
    problems: List                      # scene Problems (ref + src ids)
    blocks: Optional[Dict[int, np.ndarray]] = None   # optional masks


def _px(a):
    """A camera value with leading [...] as [..., 1, 1], to broadcast over
    the pixels of [..., H, W] fields."""
    return a[..., None, None]


def _apply33(M, x, y, z):
    m = lambda i, j: _px(M[..., i, j])
    return (m(0, 0) * x + m(0, 1) * y + m(0, 2) * z,
            m(1, 0) * x + m(1, 1) * y + m(1, 2) * z,
            m(2, 0) * x + m(2, 1) * y + m(2, 2) * z)


def _guard(h):
    return torch.where(torch.abs(h) < 1e-12, torch.full_like(h, 1e-12), h)


def _at_pixels(field, flat, lead, channels: bool = False):
    """``field`` [..., Hs, Ws] (or [..., Hs, Ws, C] with ``channels``) read
    at the flat pixel indices ``flat`` [*lead, H, W], the field's leading
    axes broadcast to ``lead``."""
    tail = tuple(field.shape[-3:] if channels else field.shape[-2:])
    n = tail[0] * tail[1]
    idx = flat.reshape(lead + (-1,))
    if not channels:
        src = field.expand(lead + tail).reshape(lead + (n,))
        return src.gather(-1, idx).reshape(flat.shape)
    C = tail[2]
    src = field.expand(lead + tail).reshape(lead + (n, C))
    out = src.gather(-2, idx[..., None].expand(lead + (idx.shape[-1], C)))
    return out.reshape(flat.shape + (C,))


def _pair_consistency(ref_depth, ref_normal, ref_cam: Camera,
                      src_depth, src_normal, src_cam: Camera, src_mask):
    """All-pixel consistency of (ref, src) pairs, on the tensors' device.

    Returns (err, rdd, angle, src_r, src_c, valid) as [..., H, W] tensors,
    with the formulas of JAX's: ``floor(x + 0.5)`` for the nearest pixel,
    the 1e-12 clamps of hz, ``jnp.hypot``'s formula and the arccos of the
    clamped cosine.  (The variant selects the thresholds only, on the
    host.)  One pair takes [H, W] fields and single cameras; a batch of
    pairs puts the same leading axes on every field and camera (or axes of
    size 1 that broadcast), and each pair's values are the ones a call on
    that pair alone computes: every op is elementwise or a gather."""
    H, W = ref_depth.shape[-2:]
    dev = ref_depth.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    T = lambda M: M.transpose(-1, -2)

    # ref pixel -> world
    px = ref_depth * (xs - _px(ref_cam.cx)) / _px(ref_cam.fx)
    py = ref_depth * (ys - _px(ref_cam.cy)) / _px(ref_cam.fy)
    wx, wy, wz = _apply33(T(ref_cam.R), px, py, ref_depth)
    c = ref_cam.c
    wx, wy, wz = (wx + _px(c[..., 0]), wy + _px(c[..., 1]),
                  wz + _px(c[..., 2]))

    # project into src
    st = src_cam.t
    sx_, sy_, sz_ = _apply33(src_cam.R, wx, wy, wz)
    sx_, sy_, sz_ = (sx_ + _px(st[..., 0]), sy_ + _px(st[..., 1]),
                     sz_ + _px(st[..., 2]))
    hx, hy, hz = _apply33(src_cam.K, sx_, sy_, sz_)
    hz = _guard(hz)
    spx = hx / hz
    spy = hy / hz
    src_c = torch.floor(spx + 0.5).to(torch.int32)
    src_r = torch.floor(spy + 0.5).to(torch.int32)
    Hs, Ws = src_depth.shape[-2:]
    inb = (src_c >= 0) & (src_c < Ws) & (src_r >= 0) & (src_r < Hs)
    rc = torch.clamp(src_r, 0, Hs - 1)
    cc = torch.clamp(src_c, 0, Ws - 1)
    sflat = (rc * Ws + cc).to(torch.int64)
    lead = tuple(sflat.shape[:-2])
    sd = _at_pixels(src_depth, sflat, lead)
    sn = _at_pixels(src_normal, sflat, lead, channels=True)
    smask = _at_pixels(src_mask, sflat, lead)

    # src pixel -> world -> reproject into ref
    bx = sd * (cc.to(torch.float32) - _px(src_cam.cx)) / _px(src_cam.fx)
    by = sd * (rc.to(torch.float32) - _px(src_cam.cy)) / _px(src_cam.fy)
    wx2, wy2, wz2 = _apply33(T(src_cam.R), bx, by, sd)
    sc = src_cam.c
    wx2, wy2, wz2 = (wx2 + _px(sc[..., 0]), wy2 + _px(sc[..., 1]),
                     wz2 + _px(sc[..., 2]))
    rt = ref_cam.t
    rx_, ry_, rz_ = _apply33(ref_cam.R, wx2, wy2, wz2)
    rx_, ry_, rz_ = (rx_ + _px(rt[..., 0]), ry_ + _px(rt[..., 1]),
                     rz_ + _px(rt[..., 2]))
    h2x, h2y, h2z = _apply33(ref_cam.K, rx_, ry_, rz_)
    h2z = _guard(h2z)
    bpx = h2x / h2z
    bpy = h2y / h2z

    err = fmath.hypot(xs - bpx, ys - bpy)
    # APD.cpp:1923: the reference reuses proj_depth from the backward
    # projection (the ref-frame depth of the src point)
    rdd = torch.abs(h2z - ref_depth) / torch.clamp(ref_depth, min=1e-12)
    cosang = torch.clamp(
        torch.sum(ref_normal * sn, dim=-1)
        / torch.clamp(fmath.norm(ref_normal, dim=-1) * fmath.norm(sn, dim=-1),
                      min=1e-12), -1.0, 1.0)
    angle = fmath.acos(cosang)
    valid = inb & (sd > 0) & (smask == 0)
    return err, rdd, angle, src_r, src_c, valid


def _accept(variant: str, errs, rdds, angs, vals, weak, ref_ok, n_src: int):
    """One reference view's acceptance [H, W] and support sets [n, H, W]
    from its pair fields [n, H, W] (rows past ``n_src`` invalid), by the
    variant's thresholds (the module docstring)."""
    if variant == "eth3d":
        support = vals & (errs < 2.0) & (rdds < 0.01) & (angs < 0.174533)
        dyn = np.where(support,
                       np.exp(-(errs + 200.0 * rdds + 10.0 * angs)), 0.0)
        n_cons = support.sum(axis=0)
        dyn_sum = dyn.sum(axis=0)
        factor = np.where(weak == PixelState.WEAK, 0.45, 0.3)
        return ref_ok & (n_cons >= 1) & (dyn_sum > factor * n_cons), support
    depth_base = (1.0 / 3500.0 if variant == "tat_intermediate"
                  else 1.0 / 3000.0)
    accept = np.zeros(ref_ok.shape, bool)
    used = np.zeros_like(vals)
    for k in range(2, n_src + 1):
        cond = vals & (errs < 0.25 * k) & (rdds < depth_base * k)
        if variant == "tat_intermediate":
            cond &= angs < (0.05235988 * k + 0.06981317)
        newly = ref_ok & (cond.sum(axis=0) >= k) & ~accept
        accept |= newly
        used = np.where(newly[None], cond, used)
    return accept, used & accept[None]


def _take_camera(cams: Camera, index) -> Camera:
    """The cameras of a stacked Camera at ``index`` (any index shape)."""
    return Camera(**{f.name: getattr(cams, f.name)[index]
                     for f in dataclasses.fields(Camera)})


def _all_pairs_consistency(ref_depths, ref_normals, ref_cams: Camera,
                           src_index, all_cams: Camera, rows=None):
    """Consistency fields for every (ref, src) pair in one batch.

    ref_depths/normals: [B, H, W(,3)] per-problem state on the device;
    src_index [B, Vm]: problem indices of each ref's sources (pad = repeat);
    all_cams: Camera with leading [B]; ``rows``: the references to compute
    (a slice; default all).  Returns the six fields of _pair_consistency as
    [rows, Vm, H, W] tensors.

    Indexing the depth/normal stacks by ``src_index`` is the fusion
    analogue of dist.sharding.exchange_src_depths: a rank computing a slice
    of references reads every view's maps.  Masks (the serial greedy
    state) are NOT consulted: the sharded path resolves consumed pixels
    afterwards with a deterministic ownership rule (lowest problem order
    wins).
    """
    rows = slice(None) if rows is None else rows
    idx = torch.as_tensor(np.asarray(src_index), dtype=torch.int64,
                          device=ref_depths.device)[rows]
    no_mask = torch.zeros(ref_depths.shape[-2:], dtype=torch.uint8,
                          device=ref_depths.device)
    ref_cam = _take_camera(ref_cams, rows)
    ref_cam = Camera(**{f.name: getattr(ref_cam, f.name)[:, None]
                        for f in dataclasses.fields(Camera)})
    return _pair_consistency(
        ref_depths[rows][:, None], ref_normals[rows][:, None], ref_cam,
        ref_depths[idx], ref_normals[idx], _take_camera(all_cams, idx),
        no_mask)


def run_fusion_sharded(inputs: FusionInputs, variant: str = "eth3d",
                       out_ply: Optional[str] = None, group=None,
                       device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Fusion with view-parallel consistency and deterministic ownership.

    The reference's greedy consumed-pixel masks (APD.cpp:1936-1952) force
    strict view-order serialization: view r's acceptance depends on every
    earlier view's consumption.  Here:

      1. consistency fields for ALL (ref, src) pairs run as ONE batch on
         ``device`` (the card unless the caller asks for the CPU), split
         over the ranks of ``group`` by reference view (each rank computes
         a contiguous slice of references and reads every view's maps);
         the ranks all-gather the fields;
      2. ownership: a source pixel is CONSUMED by the lowest-order
         reference view that supports an accepted pixel with it in the
         mask-free pass (deterministic, order-independent computation);
      3. acceptance re-runs with consumed supports removed and consumed
         reference pixels dropped.

    Deviation from the serial greedy (documented): consumption derives
    from the mask-free acceptance instead of the running masks, so a view
    may consume pixels it would not have reached serially; measured point
    counts agree within a few percent (tests/test_pipeline.py::
    test_sharded_fusion_matches_serial).

    Every rank of ``group`` calls it and gets the cloud; rank 0 alone
    writes ``out_ply``.
    """
    from ..dist.sharding import (all_gather, group_rank, group_size,
                                 local_slice)

    assert variant in ("eth3d", "tat_intermediate", "tat_advanced")
    dev = resolve_device(device)
    probs = [p for p in inputs.problems
             if any(s in inputs.depths for s in p.src_image_ids)]
    ids = [p.ref_image_id for p in probs]
    if not ids:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    B = len(ids)
    # Source-only views (depth map present but not a retained reference
    # problem) still contribute supports, as in serial run_fusion; they
    # join the consistency batch but never emit points of their own.
    all_ids = list(ids)
    seen = set(ids)
    for p in probs:
        for s in p.src_image_ids:
            if s in inputs.depths and s not in seen:
                seen.add(s)
                all_ids.append(s)
    Ball = len(all_ids)
    order = {rid: i for i, rid in enumerate(all_ids)}
    H, W = inputs.depths[ids[0]].shape
    Vm = max(len(p.src_image_ids) for p in probs)
    src_index = np.zeros((Ball, Vm), np.int32)
    n_src = np.zeros((Ball,), np.int32)
    for i, p in enumerate(probs):
        srcs = [s for s in p.src_image_ids if s in inputs.depths]
        n_src[i] = len(srcs)
        pad = srcs + [srcs[-1] if srcs else ids[i]] * (Vm - len(srcs))
        src_index[i] = [order[s] for s in pad]
    for i in range(B, Ball):
        src_index[i] = i          # source-only rows: self-pairs, n_src = 0

    # pad the batch to a rank multiple (repeated refs; results sliced off)
    n_dev = group_size(group)
    Bp = -(-Ball // n_dev) * n_dev
    pad_ids = all_ids + [all_ids[-1]] * (Bp - Ball)
    src_index_p = np.concatenate(
        [src_index, np.repeat(src_index[-1:], Bp - Ball, axis=0)])

    on_dev = lambda a: torch.as_tensor(np.stack(a), device=dev)
    ref_depths = on_dev([np.asarray(inputs.depths[r], np.float32)
                         for r in pad_ids])
    ref_normals = on_dev([np.asarray(inputs.normals[r], np.float32)
                          for r in pad_ids])
    ref_cams = stack_cameras([inputs.cameras[r].to(dev) for r in pad_ids])
    lo, hi = local_slice(group, Bp)
    fields = _all_pairs_consistency(ref_depths, ref_normals, ref_cams,
                                    src_index_p, ref_cams, slice(lo, hi))
    errs, rdds, angs, srs, scs, vals = (
        all_gather(f, group).cpu().numpy()[:B] for f in fields)
    jvalid = (np.arange(Vm)[None] < n_src[:B, None])         # [B, Vm]
    vals = vals & jvalid[..., None, None]

    def acceptance(vals_f):
        """Per-ref acceptance + support sets given filtered validity."""
        accepts, useds = [], []
        for i, rid in enumerate(ids):
            ref_ok = inputs.depths[rid] > 0
            if inputs.blocks is not None and rid in (inputs.blocks or {}):
                ref_ok &= inputs.blocks[rid] >= 128
            accept, used = _accept(variant, errs[i], rdds[i], angs[i],
                                   vals_f[i], np.asarray(inputs.weaks[rid]),
                                   ref_ok, int(n_src[i]))
            accepts.append(accept)
            useds.append(used)
        return accepts, useds

    # pass 1: mask-free acceptance -> deterministic ownership claims
    accepts0, useds0 = acceptance(vals)
    BIG = B + 1
    consumed = np.full((Ball, H, W), BIG, np.int32)  # owner order per pixel
    for i in range(B):
        for j in range(int(n_src[i])):
            uj = useds0[i][j] & accepts0[i]
            if not uj.any():
                continue
            tgt = src_index[i, j]
            np.minimum.at(consumed[tgt],
                          (srs[i, j][uj], scs[i, j][uj]), i)

    # pass 2: drop supports/ref pixels consumed by a LOWER-order view
    vals2 = vals.copy()
    for i in range(B):
        for j in range(int(n_src[i])):
            tgt = src_index[i, j]
            own = consumed[tgt][np.clip(srs[i, j], 0, H - 1),
                                np.clip(scs[i, j], 0, W - 1)]
            vals2[i, j] &= own >= i
    accepts, useds = acceptance(vals2)

    all_pts, all_cols = [], []
    for i, rid in enumerate(ids):
        accept = accepts[i] & (consumed[i] >= i)
        ys, xs = np.nonzero(accept)
        if len(ys) == 0:
            continue
        cam = inputs.cameras[rid]
        K = cam.K.cpu().numpy()
        R = cam.R.cpu().numpy()
        c0 = cam.c.cpu().numpy()
        d0 = inputs.depths[rid][ys, xs]
        pc = np.stack([d0 * (xs - K[0, 2]) / K[0, 0],
                       d0 * (ys - K[1, 2]) / K[1, 1], d0], axis=-1)
        pw = pc @ R + c0
        col = inputs.images[rid][ys, xs].astype(np.float64)
        cnt = np.ones(len(ys))
        for j in range(int(n_src[i])):
            uj = useds[i][j, ys, xs]
            if not np.any(uj):
                continue
            sid = all_ids[src_index[i, j]]
            col[uj] += inputs.images[sid][srs[i, j, ys, xs][uj],
                                          scs[i, j, ys, xs][uj]]
            cnt[uj] += 1
        all_pts.append(pw.astype(np.float32))
        all_cols.append((col / cnt[:, None])[:, ::-1].astype(np.uint8))

    if all_pts:
        pts = np.concatenate(all_pts)
        cols = np.concatenate(all_cols)
    else:
        pts = np.zeros((0, 3), np.float32)
        cols = np.zeros((0, 3), np.uint8)
    if out_ply is not None and group_rank(group) == 0:
        write_ply(out_ply, pts, cols)
    return pts, cols


def run_fusion(inputs: FusionInputs, variant: str = "eth3d",
               out_ply: Optional[str] = None, device=None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse all views -> (points [N, 3], colors_bgr [N, 3]).  The pair
    tests run on ``device`` (the card unless the caller asks for the
    CPU)."""
    assert variant in ("eth3d", "tat_intermediate", "tat_advanced")
    dev = resolve_device(device)
    ids = [p.ref_image_id for p in inputs.problems]
    masks = {i: np.zeros(inputs.depths[i].shape, np.uint8) for i in ids}
    on_dev = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    depths = {i: on_dev(d) for i, d in inputs.depths.items()}
    normals = {i: on_dev(n) for i, n in inputs.normals.items()}
    cams = {i: c.to(dev) for i, c in inputs.cameras.items()}

    all_pts: List[np.ndarray] = []
    all_cols: List[np.ndarray] = []

    for prob in inputs.problems:
        rid = prob.ref_image_id
        ref_depth = inputs.depths[rid]
        ref_cam = inputs.cameras[rid]
        src_ids = [s for s in prob.src_image_ids if s in inputs.depths]
        n_src = len(src_ids)
        if n_src == 0:
            continue

        fields = [_pair_consistency(depths[rid], normals[rid], cams[rid],
                                    depths[sid], normals[sid], cams[sid],
                                    on_dev(masks[sid]))
                  for sid in src_ids]
        errs, rdds, angs, srs, scs, vals = (
            torch.stack([f[k] for f in fields]).cpu().numpy()
            for k in range(6))

        ref_ok = (ref_depth > 0) & (masks[rid] == 0)
        if inputs.blocks is not None and rid in (inputs.blocks or {}):
            ref_ok &= inputs.blocks[rid] >= 128
        accept, used = _accept(variant, errs, rdds, angs, vals,
                               np.asarray(inputs.weaks[rid]), ref_ok, n_src)

        ys, xs = np.nonzero(accept)
        if len(ys) == 0:
            continue
        # world points of accepted ref pixels
        K = ref_cam.K.cpu().numpy()
        R = ref_cam.R.cpu().numpy()
        cc0 = ref_cam.c.cpu().numpy()
        d0 = ref_depth[ys, xs]
        pc = np.stack([d0 * (xs - K[0, 2]) / K[0, 0],
                       d0 * (ys - K[1, 2]) / K[1, 1], d0], axis=-1)
        pw = pc @ R + cc0

        img = inputs.images[rid]
        col = img[ys, xs].astype(np.float64)
        cnt = np.ones(len(ys))
        for j, sid in enumerate(src_ids):
            uj = used[j, ys, xs]
            if not np.any(uj):
                continue
            sr = srs[j, ys, xs][uj]
            sc = scs[j, ys, xs][uj]
            # consume src pixels (greedy masking, reference view order)
            masks[sid][sr, sc] = 1
            col[uj] += inputs.images[sid][sr, sc]
            cnt[uj] += 1
        col = col / cnt[:, None]

        all_pts.append(pw.astype(np.float32))
        # PLY colors are BGR (reference OpenCV heritage)
        all_cols.append(col[:, ::-1].astype(np.uint8))

    if all_pts:
        pts = np.concatenate(all_pts)
        cols = np.concatenate(all_cols)
    else:
        pts = np.zeros((0, 3), np.float32)
        cols = np.zeros((0, 3), np.uint8)

    if out_ply is not None:
        write_ply(out_ply, pts, cols)
    return pts, cols
