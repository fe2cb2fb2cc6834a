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
PyTorch ops on the device, one pair at a time; the greedy consumed-pixel
masking runs as a host-sequential numpy loop over reference views in
``problems`` order, as in the reference (the masks are the only cross-view
mutable state).  The batched all-pairs program and the sharded fusion wait
for ROADMAP.md Queue 1 item 6.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import fmath, resolve_device
from ..config import PixelState
from ..geometry.camera import Camera
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


def _apply33(M, x, y, z):
    return (M[0, 0] * x + M[0, 1] * y + M[0, 2] * z,
            M[1, 0] * x + M[1, 1] * y + M[1, 2] * z,
            M[2, 0] * x + M[2, 1] * y + M[2, 2] * z)


def _guard(h):
    return torch.where(torch.abs(h) < 1e-12, torch.full_like(h, 1e-12), h)


def _pair_consistency(ref_depth, ref_normal, ref_cam: Camera,
                      src_depth, src_normal, src_cam: Camera, src_mask):
    """All-pixel consistency of one (ref, src) pair, on the tensors' device.

    Returns (err, rdd, angle, src_r, src_c, valid) as [H, W] tensors, with
    the formulas of JAX's: ``floor(x + 0.5)`` for the nearest pixel, the
    1e-12 clamps of hz, ``jnp.hypot``'s formula and the arccos of the
    clamped cosine.  (The variant selects the thresholds only, on the
    host.)"""
    H, W = ref_depth.shape
    dev = ref_depth.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)

    # ref pixel -> world
    px = ref_depth * (xs - ref_cam.cx) / ref_cam.fx
    py = ref_depth * (ys - ref_cam.cy) / ref_cam.fy
    wx, wy, wz = _apply33(ref_cam.R.T, px, py, ref_depth)
    c = ref_cam.c
    wx, wy, wz = wx + c[0], wy + c[1], wz + c[2]

    # project into src
    sx_, sy_, sz_ = _apply33(src_cam.R, wx, wy, wz)
    sx_, sy_, sz_ = sx_ + src_cam.t[0], sy_ + src_cam.t[1], sz_ + src_cam.t[2]
    hx, hy, hz = _apply33(src_cam.K, sx_, sy_, sz_)
    hz = _guard(hz)
    spx = hx / hz
    spy = hy / hz
    src_c = torch.floor(spx + 0.5).to(torch.int32)
    src_r = torch.floor(spy + 0.5).to(torch.int32)
    Hs, Ws = src_depth.shape
    inb = (src_c >= 0) & (src_c < Ws) & (src_r >= 0) & (src_r < Hs)
    rc = torch.clamp(src_r, 0, Hs - 1)
    cc = torch.clamp(src_c, 0, Ws - 1)
    sflat = (rc * Ws + cc).to(torch.int64)
    sd = src_depth.reshape(-1)[sflat]
    sn = src_normal.reshape(-1, 3)[sflat]
    smask = src_mask.reshape(-1)[sflat]

    # src pixel -> world -> reproject into ref
    bx = sd * (cc.to(torch.float32) - src_cam.cx) / src_cam.fx
    by = sd * (rc.to(torch.float32) - src_cam.cy) / src_cam.fy
    wx2, wy2, wz2 = _apply33(src_cam.R.T, bx, by, sd)
    sc = src_cam.c
    wx2, wy2, wz2 = wx2 + sc[0], wy2 + sc[1], wz2 + sc[2]
    rx_, ry_, rz_ = _apply33(ref_cam.R, wx2, wy2, wz2)
    rx_, ry_, rz_ = rx_ + ref_cam.t[0], ry_ + ref_cam.t[1], rz_ + ref_cam.t[2]
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
        H, W = ref_depth.shape
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

        weak = np.asarray(inputs.weaks[rid])
        ref_ok = (ref_depth > 0) & (masks[rid] == 0)
        if inputs.blocks is not None and rid in (inputs.blocks or {}):
            ref_ok &= inputs.blocks[rid] >= 128

        if variant == "eth3d":
            support = vals & (errs < 2.0) & (rdds < 0.01) & (angs < 0.174533)
            dyn = np.where(support,
                           np.exp(-(errs + 200.0 * rdds + 10.0 * angs)), 0.0)
            n_cons = support.sum(axis=0)
            dyn_sum = dyn.sum(axis=0)
            factor = np.where(weak == PixelState.WEAK, 0.45, 0.3)
            accept = ref_ok & (n_cons >= 1) & (dyn_sum > factor * n_cons)
            used = support
        else:
            depth_base = (1.0 / 3500.0 if variant == "tat_intermediate"
                          else 1.0 / 3000.0)
            accept = np.zeros((H, W), bool)
            used = np.zeros_like(vals)
            for k in range(2, n_src + 1):
                cond = vals & (errs < 0.25 * k) & (rdds < depth_base * k)
                if variant == "tat_intermediate":
                    cond &= angs < (0.05235988 * k + 0.06981317)
                cnt = cond.sum(axis=0)
                newly = ref_ok & (cnt >= k) & ~accept
                accept |= newly
                used = np.where(newly[None], cond, used)
            used = used & accept[None]

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
