"""The candidate-dependent anchor term of the weak-pixel cost (counterpart
of ``dvpmvs/kernels/deformable.py``, production mode).

Oracle: ``ComputeBilateralNCCNew`` (APD.cu:835-1021): for a WEAK pixel the
cost is 0.25 x the center-window NCC + 0.75 x an anchor term.  dvpmvs's
production anchor term, kept here, is a grouped weighted NCC over the anchor
CENTER samples, each warped by the homography of the plane being evaluated
(``anchor_cost_term_for_plane``), restricted to a compacted list of weak
pixels.  Per-view visibility gating and the out-of-view cost_max blend follow
the reference.

``anchor_cost_term_for_plane`` here is the fp32 branch of the JAX function
(bilinear samples of the fp32 sources) and is the plain version of K4
(``anchor_fused.py``), with its sparse-patch tap mode (``anchor_taps > 1``:
``pack_tap_fields`` once a pass, ``gather_tap_words`` at the compacted
anchors; the words' u8 weight and ref quantization is the semantics JAX's
oracle and kernel share).  ``anchor_cost_term`` is the candidate-independent
variant over the current plane's warped field (K5), kept, as in JAX, beside
the engine: nothing on the engine's path calls it.  ``deformable_cost_exact``
is the reference-exact 9-tap oracle (``PMStatic.exact_deformable``): plain
PyTorch, as JAX's is XLA code and not a Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import fmath
from .ncc import (COST_MAX, CostContext, _guard, bilinear_sample, ncc_cost,
                  warp_field)
from .sampling import identity_pack
from .weak import AnchorResult

_MIN_ANCHOR_SAMPLES = 4
_MIN_GROUP_SAMPLES = 2   # per-group NCC validity (total gate stays at 4)
_K_MIN_VAR = 1e-5


class AnchorCostTerm(NamedTuple):
    cost: torch.Tensor         # [..., V] anchor-part cost (cost_max fallback)
    has_anchors: torch.Tensor  # [..., V] any usable anchor sample


class AnchorFields(NamedTuple):
    """Per-evaluated-pixel anchor data, candidate-independent, at the
    compacted evaluation pixels.  Anchor coordinates stay full-resolution."""
    ax: torch.Tensor        # [A, K] int32 anchor x
    ay: torch.Tensor        # [A, K] int32 anchor y
    rax: torch.Tensor       # [A, K] anchor ray x
    ray: torch.Tensor       # [A, K] anchor ray y
    valid: torch.Tensor     # [A, K] bool
    ref_a: torch.Tensor     # [A, K] ref intensity at the anchor
    w_col: torch.Tensor     # [A, K] color weight against the evaluated pixel
    sees: torch.Tensor      # [V, A, K] the anchor sees view v


def _sum0(terms):
    """terms[0] + terms[1] + ... in order (XLA's reduction order)."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def anchor_cost_term(ctx: CostContext, plane: torch.Tensor,
                     af: AnchorFields) -> AnchorCostTerm:
    """Weighted NCC over the anchor-center samples of the CURRENT plane
    field's warped sources (candidate-independent): plane [H, W, 4] (full
    grid), ``af`` on its evaluation grid -> cost and has [*P, V].

    JAX's fp32 branch: the warped field and its in-view mask (K5) gathered
    at the anchors; one ungrouped NCC over the anchors, sums in anchor
    order.  (JAX's pallas backend quantizes the warped field to u8 first.)"""
    H, W = plane.shape[:2]
    warped, in_view = warp_field(ctx, plane)                # [V, H, W]
    idx = (af.ay * W + af.ax).to(torch.int64)               # [A, *P]
    src_a = warped.reshape(warped.shape[0], -1)[:, idx]     # [V, A, *P]
    inv_a = in_view.reshape(in_view.shape[0], -1)[:, idx]
    usable = af.valid[None] & af.sees & inv_a
    oov = af.valid[None] & af.sees & ~inv_a
    w = torch.where(usable, af.w_col[None], torch.zeros_like(src_a))
    ref = af.ref_a[None]
    A = af.ax.shape[0]
    over_a = lambda x: _sum0([x[:, a] for a in range(A)])
    sw = over_a(w)
    n_use = over_a(usable.to(torch.int32))
    n_oov = over_a(oov.to(torch.int32))
    inv = 1.0 / torch.clamp(sw, min=1e-30)
    m_ref = over_a(w * ref) * inv
    m_ref2 = over_a(w * (ref * ref)) * inv
    m_src = over_a(w * src_a) * inv
    m_src2 = over_a(w * (src_a * src_a)) * inv
    m_rs = over_a(w * ref * src_a) * inv
    var_r = m_ref2 - m_ref * m_ref
    var_s = m_src2 - m_src * m_src
    cov = m_rs - m_ref * m_src
    ncc = cov / torch.clamp(fmath.sqrt(torch.clamp(var_r * var_s, min=0.0)),
                            min=1e-30)
    c = torch.clamp(1.0 - ncc, 0.0, COST_MAX)
    bad = (var_r < _K_MIN_VAR) | (var_s < _K_MIN_VAR) | (
        n_use < _MIN_ANCHOR_SAMPLES)
    c = torch.where(bad, torch.full_like(c, COST_MAX), c)
    tot = torch.clamp(n_use + n_oov, min=1)
    c = (c * n_use + COST_MAX * n_oov) / tot
    has = (n_use + n_oov) > 0
    return AnchorCostTerm(cost=torch.movedim(c, 0, -1),
                          has_anchors=torch.movedim(has, 0, -1))


def pack_anchor_fields(ctx: CostContext, anchors: AnchorResult,
                       sel_views: torch.Tensor, ref_img: torch.Tensor,
                       sigma_color, pk=identity_pack) -> AnchorFields:
    """AnchorFields of every pixel of the evaluation grid that ``pk(arr,
    axis)`` packs to (the identity: the full grid), as dense [A, H', W']
    fields ([V, A, H', W'] for ``sees``)."""
    Hp, Wp = pk(ref_img, 0).shape
    gidx = torch.arange(Hp * Wp, device=ref_img.device)
    af = anchor_fields_at(ctx, anchors, sel_views, ref_img, sigma_color, pk,
                          gidx)
    return AnchorFields(*(x.reshape(x.shape[:-1] + (Hp, Wp)) for x in af))


def deformable_cost(ctx_yzl: CostContext, plane_candidate: torch.Tensor,
                    anchor_term: AnchorCostTerm, parity=None) -> torch.Tensor:
    """0.25 x the center-window NCC (color-only weights) + 0.75 x the
    anchor term where it has anchors, the center window alone elsewhere:
    plane_candidate [H', W', 4] -> [H', W', V]."""
    center = ncc_cost(ctx_yzl, plane_candidate, parity=parity)
    return torch.where(anchor_term.has_anchors,
                       0.25 * center + 0.75 * anchor_term.cost, center)


# The reference's fallback offsets for EMPTY patch-candidate slots (the fixed
# +-weak_radius grid, APD.cu:944-948), in slot order.
TAP_FALLBACK = np.array(
    [(-5, -5), (-5, 0), (-5, 5), (0, -5), (0, 5),
     (5, -5), (5, 0), (5, 5)], np.int32)


def pack_tap_fields(ref_img: torch.Tensor, patch_off: torch.Tensor,
                    n_extra: int) -> torch.Tensor:
    """Dense per-anchor-position tap fields [V, H, W] int32, once a pass.

    Tap t of an anchor AT pixel (x, y) of view v reads 16 bits t of word
    [v, y, x]: ``(dy+8) | (dx+8) << 4 | round(ref[tap]) << 8``, where
    (dx, dy) is the patch-candidate offset ``patch_off[v, t]`` (an empty
    slot takes ``TAP_FALLBACK[t]``) clipped to the image.  n_extra is 1 or
    2 (two 16-bit taps fill one int32 word)."""
    if not 1 <= n_extra <= 2:
        raise ValueError(f"pack_tap_fields: n_extra must be 1 or 2, got "
                         f"{n_extra}")
    H, W = ref_img.shape
    V = patch_off.shape[0]
    dev = ref_img.device
    ys = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    refq = torch.clamp(torch.round(ref_img), 0, 255).to(torch.int32)
    words = torch.zeros((V, H, W), dtype=torch.int32, device=dev)
    for t in range(n_extra):
        off = patch_off[:, t].to(torch.int32)               # [V, H, W, 2]
        oi, oj = off[..., 0], off[..., 1]
        empty = (oi == 0) & (oj == 0)
        oi = torch.where(empty, int(TAP_FALLBACK[t, 0]), oi)
        oj = torch.where(empty, int(TAP_FALLBACK[t, 1]), oj)
        tx = torch.clamp(xs + oi, 0, W - 1)
        ty = torch.clamp(ys + oj, 0, H - 1)
        rq = refq.reshape(-1)[(ty * W + tx).to(torch.int64)]
        word_t = (ty - ys + 8) | ((tx - xs + 8) << 4) | (rq << 8)
        words = words | (word_t << (16 * t))
    return words


def gather_tap_words(tap_fields: torch.Tensor, af: AnchorFields,
                     ref_c: torch.Tensor, sigma_color, W: int,
                     n_extra: int) -> torch.Tensor:
    """Sample words [V, n_extra, A, K] int32 at the compacted pixels:
    ``pack_tap_fields``' words gathered at the anchors (one gather serves
    every tap), each tap's bilateral color weight against the evaluated
    pixel's intensity ``ref_c`` [K] quantized to u8:
    ``(dy+8) | (dx+8) << 4 | wq << 8 | refq << 16``."""
    sc = torch.as_tensor(sigma_color, dtype=torch.float32,
                         device=tap_fields.device)
    idx = (af.ay * W + af.ax).to(torch.int64)               # [A, K]
    tw = tap_fields.reshape(tap_fields.shape[0], -1)[:, idx]  # [V, A, K]
    out = []
    for t in range(n_extra):
        sub = (tw >> (16 * t)) & 0xFFFF
        refq = (sub >> 8) & 0xFF
        w = fmath.exp(-torch.abs(refq.to(torch.float32) - ref_c[None, None])
                      / (2.0 * sc * sc))
        wq = torch.round(w * 255.0).to(torch.int32)
        out.append((sub & 0xFF) | (wq << 8) | (refq << 16))
    return torch.stack(out, dim=1)


def unpack_tap_word(word: torch.Tensor):
    """int32 sample word -> (dx, dy, weight f32 in [0, 1], ref f32)."""
    dy = (word & 0xF) - 8
    dx = ((word >> 4) & 0xF) - 8
    w = ((word >> 8) & 0xFF).to(torch.float32) * (1.0 / 255.0)
    ref = ((word >> 16) & 0xFF).to(torch.float32)
    return dx, dy, w, ref


def anchor_fields_at(ctx: CostContext, anchors: AnchorResult,
                     sel_views: torch.Tensor, ref_img: torch.Tensor,
                     sigma_color, pk, gidx: torch.Tensor,
                     ref_eval=None) -> AnchorFields:
    """AnchorFields at compacted evaluation-grid indices ``gidx`` [K] into
    the flattened grid that ``pk(arr, axis)`` packs ``anchors``' fields to
    (one checkerboard color, or the identity for the full grid).
    ``ref_eval`` is the reference image on that grid (``pk(ref_img, 0)`` by
    default; a row window of the tiled pass gives its own)."""
    H, W = ref_img.shape
    V = ctx.num_views
    gidx = gidx.to(torch.int64)
    flatk = lambda x: x.reshape(x.shape[0], -1)[:, gidx]
    ax = flatk(pk(torch.clamp(anchors.coords[..., 0], 0, W - 1), 1))
    ay = flatk(pk(torch.clamp(anchors.coords[..., 1], 0, H - 1), 1))
    valid = flatk(pk(anchors.valid, 1))
    idx = (ay * W + ax).to(torch.int64)
    ref_a = ref_img.reshape(-1)[idx]
    ref_c = (pk(ref_img, 0) if ref_eval is None
             else ref_eval).reshape(-1)[gidx]
    sc = torch.as_tensor(sigma_color, dtype=torch.float32,
                         device=ref_img.device)
    w_col = fmath.exp(-torch.abs(ref_a - ref_c[None]) / (2.0 * sc * sc))
    sel_bits = torch.zeros((H, W), dtype=torch.int32, device=ref_img.device)
    for v in range(V):
        sel_bits = sel_bits | (sel_views[..., v].to(torch.int32) << v)
    selb_a = sel_bits.reshape(-1)[idx]
    sees = torch.stack([((selb_a >> v) & 1).to(torch.bool)
                        for v in range(V)])
    rax = (ax.to(torch.float32) - ctx.cam[0]) * ctx.inv_fx
    ray_ = (ay.to(torch.float32) - ctx.cam[1]) * ctx.inv_fy
    return AnchorFields(ax=ax, ay=ay, rax=rax, ray=ray_, valid=valid,
                        ref_a=ref_a, w_col=w_col, sees=sees)


def slot_q(planes: torch.Tensor) -> torch.Tensor:
    """q = n / w of plane fields [..., 4] -> [..., 3] (w guarded)."""
    return planes[..., :3] / _guard(planes[..., 3:4])


def anchor_term_from_q(src, M, b, src_wh, q, rax, ray, ref_a, w_col,
                       usable_bits, tap_words=None, inv_f=None
                       ) -> AnchorCostTerm:
    """The anchor term of one slot: q [*P, 3] per evaluated pixel; rax, ray,
    ref_a, w_col [A, *P]; usable_bits [V, A, *P] (valid & sees).  With
    ``tap_words`` [V, n_extra, A, *P] (``gather_tap_words``) and ``inv_f``
    (1/fx, 1/fy of the reference) each anchor adds its sparse-patch taps to
    its group: sampled at the ray (rax + dx/fx, ray + dy/fy) under the slot
    plane, weighted by the word's weight where the CENTER is usable, never
    counted.  Returns cost and has [*P, V].

    Accumulates anchor by anchor (each anchor's center, then its taps, the
    order of JAX's flattened (anchor, tap) sample axis) and group by group,
    and forms each product as JAX's expression does (w * r^2, (w * r) * s):
    K4 does the same operations in the same order."""
    V = src.shape[0]
    A = rax.shape[0]
    G = max(A // _MIN_ANCHOR_SAMPLES, 1)
    Ag = -(-A // G)
    n_extra = 0 if tap_words is None else tap_words.shape[1]
    q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
    f = lambda x: x.to(torch.float32)
    costs, hass = [], []
    for v in range(V):
        m = M[v]
        bv = b[v]

        def warp_sample(ra, ya):
            s_i = q0 * ra + q1 * ya + q2
            hx = m[0, 0] * ra + m[0, 1] * ya + m[0, 2] - bv[0] * s_i
            hy = m[1, 0] * ra + m[1, 1] * ya + m[1, 2] - bv[1] * s_i
            hz = m[2, 0] * ra + m[2, 1] * ya + m[2, 2] - bv[2] * s_i
            front = hz > 0
            hz = _guard(hz)
            px = hx / hz
            py = hy / hz
            in_view = ((px >= 0) & (px < src_wh[v, 0]) & (py >= 0)
                       & (py < src_wh[v, 1]) & front)
            return bilinear_sample(src[v], px, py), in_view

        use_a, oov_a, samples = [], [], []
        for a in range(A):
            center, in_view = warp_sample(rax[a], ray[a])
            use_a.append(usable_bits[v, a] & in_view)
            oov_a.append(usable_bits[v, a] & ~in_view)
            # (weight where usable, ref, src) of the center and each tap
            samp = [(w_col[a], ref_a[a], center)]
            for t in range(n_extra):
                dx, dy, wt, rt = unpack_tap_word(tap_words[v, t, a])
                tap, _ = warp_sample(rax[a] + f(dx) * inv_f[0],
                                     ray[a] + f(dy) * inv_f[1])
                samp.append((wt, rt, tap))
            samples.append(samp)
        c_num = n_sum = None
        for g in range(G):
            members = range(g * Ag, min((g + 1) * Ag, A))
            c0 = ref_a[g * Ag]
            sw = s_r = s_r2 = s_s = s_s2 = s_rs = None
            for a in members:
                for w_e, ref_e, src_e in samples[a]:
                    w = torch.where(use_a[a], w_e, torch.zeros_like(w_e))
                    r = ref_e - c0
                    s = src_e - c0
                    terms = (w, w * r, w * (r * r), w * s, w * (s * s),
                             w * r * s)
                    if sw is None:
                        sw, s_r, s_r2, s_s, s_s2, s_rs = terms
                    else:
                        sw, s_r, s_r2, s_s, s_s2, s_rs = (
                            x + t for x, t in zip(
                                (sw, s_r, s_r2, s_s, s_s2, s_rs), terms))
            n_g = _sum0([f(use_a[a]) for a in members])
            inv = 1.0 / torch.clamp(sw, min=1e-30)
            m_ref = s_r * inv
            m_ref2 = s_r2 * inv
            m_src = s_s * inv
            m_src2 = s_s2 * inv
            m_rs = s_rs * inv
            var_r = m_ref2 - m_ref * m_ref
            var_s = m_src2 - m_src * m_src
            cov = m_rs - m_ref * m_src
            ncc = cov / torch.clamp(fmath.sqrt(torch.clamp(var_r * var_s,
                                                           min=0.0)),
                                    min=1e-30)
            cg = torch.clamp(1.0 - ncc, 0.0, COST_MAX)
            bad = ((var_r < _K_MIN_VAR) | (var_s < _K_MIN_VAR)
                   | (n_g < _MIN_GROUP_SAMPLES))
            cg = torch.where(bad, torch.full_like(cg, COST_MAX), cg)
            if c_num is None:
                c_num, n_sum = cg * n_g, n_g
            else:
                c_num, n_sum = c_num + cg * n_g, n_sum + n_g
        n_use = _sum0([f(u) for u in use_a])
        n_oov = _sum0([f(o) for o in oov_a])
        c = c_num / torch.clamp(n_sum, min=1.0)
        c = torch.where(n_use < _MIN_ANCHOR_SAMPLES,
                        torch.full_like(c, COST_MAX), c)
        tot = torch.clamp(n_use + n_oov, min=1.0)
        c = (c * n_use + COST_MAX * n_oov) / tot
        costs.append(c)
        hass.append((n_use + n_oov) > 0)
    return AnchorCostTerm(cost=torch.stack(costs, dim=-1),
                          has_anchors=torch.stack(hass, dim=-1))


def anchor_cost_term_for_plane(ctx: CostContext, plane_field: torch.Tensor,
                               af: AnchorFields, tap_words=None
                               ) -> AnchorCostTerm:
    """Candidate-dependent anchor term of one slot's plane field
    [*P, 4] at the evaluated pixels of ``af`` (exact homography semantics,
    one sample per anchor center, plus the sparse-patch taps of
    ``tap_words`` [V, n_extra, A, *P] where given): cost and has [*P, V]."""
    return anchor_term_from_q(
        ctx.src_imgs, ctx.M, ctx.b, ctx.src_wh, slot_q(plane_field),
        af.rax, af.ray, af.ref_a, af.w_col, af.valid[None] & af.sees,
        tap_words, (ctx.inv_fx, ctx.inv_fy))


def deformable_cost_exact(ctx_yzl: CostContext, plane_candidate: torch.Tensor,
                          anchors: AnchorResult, patch_off: torch.Tensor,
                          sel_views: torch.Tensor, ref_img: torch.Tensor,
                          sigma_color, rows=None, rays=None) -> torch.Tensor:
    """EXACT ``ComputeBilateralNCCNew`` (APD.cu:835-1021): per anchor and
    per view a 9-tap sparse-patch NCC with the anchor's per-view candidate
    offsets (``patch_off`` [V, 8, H, W, 2], ``patch_candidates``), every tap
    warped through the candidate plane of the EVALUATED pixel.  Zero-offset
    slots fall back to the +-5 grid, slot 8 is the anchor center, and a
    visible anchor that is not selected counts as COST_MAX.  plane_candidate
    [H, W, 4] (full grid) -> 0.25 x center NCC + 0.75 x the anchors' mean
    [H, W, V].

    The gathers of a view run batched over taps and anchors ([9, A, H, W]);
    the sums keep JAX's order: taps k = 0..8 in sequence into the six
    moment sums, anchors a = 0..A-1 in sequence into the cost sum.

    With ``rows`` (an ``engine.rows.RowWindow``) the evaluated pixels are
    its compute rows (``ctx_yzl``, ``plane_candidate`` and ``anchors`` on
    them) and ``rays`` the whole (rx, ry) grids that the taps read."""
    H, W = ref_img.shape
    V = ctx_yzl.num_views
    dev = ref_img.device
    sc = torch.as_tensor(sigma_color, dtype=torch.float32, device=dev)
    q = slot_q(plane_candidate)                             # [H, W, 3]
    q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
    rx_f, ry_f = rays if rays is not None else (ctx_yzl.rx, ctx_yzl.ry)
    rx_f, ry_f = rx_f.reshape(-1), ry_f.reshape(-1)
    ref_eval = ref_img if rows is None else rows.take(ref_img)
    Hc = ref_eval.shape[0]

    def warp(v, tidx):
        """Source position of the ref pixels ``tidx`` under the evaluated
        pixel's candidate plane."""
        rx, ry = rx_f[tidx], ry_f[tidx]
        m, bv = ctx_yzl.M[v], ctx_yzl.b[v]
        s_ = q0 * rx + q1 * ry + q2
        hx = m[0, 0] * rx + m[0, 1] * ry + m[0, 2] - bv[0] * s_
        hy = m[1, 0] * rx + m[1, 1] * ry + m[1, 2] - bv[1] * s_
        hz = m[2, 0] * rx + m[2, 1] * ry + m[2, 2] - bv[2] * s_
        front = hz > 0
        hz = _guard(hz)
        return hx / hz, hy / hz, front

    ax = torch.clamp(anchors.coords[..., 0], 0, W - 1).to(torch.int64)
    ay = torch.clamp(anchors.coords[..., 1], 0, H - 1).to(torch.int64)
    aidx = ay * W + ax                                      # [A, H, W]
    A = aidx.shape[0]
    sees_all = sel_views.reshape(-1, V)[aidx]               # [A, H, W, V]
    # tap offsets: slots 0..7 from the candidates (empty -> the fallback
    # grid), slot 8 the anchor center
    fb = torch.as_tensor(TAP_FALLBACK, dtype=torch.int64, device=dev)
    fb_i = fb[:, 0].reshape(8, 1, 1, 1)
    fb_j = fb[:, 1].reshape(8, 1, 1, 1)
    zero = torch.zeros((1, A, Hc, W), dtype=torch.int64, device=dev)
    ref_f = ref_img.reshape(-1)
    center = ncc_cost(ctx_yzl, plane_candidate)             # [H, W, V]

    out = []
    for v in range(V):
        sx, sy, front = warp(v, aidx)                       # [A, H, W]
        in_view = ((sx >= 0) & (sx < ctx_yzl.src_wh[v, 0]) & (sy >= 0)
                   & (sy < ctx_yzl.src_wh[v, 1]) & front)
        off = patch_off[v].reshape(8, H * W, 2)[:, aidx].to(torch.int64)
        oi, oj = off[..., 0], off[..., 1]                   # [8, A, H, W]
        empty = (oi == 0) & (oj == 0)
        oi = torch.cat([torch.where(empty, fb_i, oi), zero])
        oj = torch.cat([torch.where(empty, fb_j, oj), zero])
        tx = torch.clamp(ax + oi, 0, W - 1)                 # [9, A, H, W]
        ty = torch.clamp(ay + oj, 0, H - 1)
        tidx = ty * W + tx
        ref_pix = ref_f[tidx]
        px, py, _ = warp(v, tidx)
        src_pix = bilinear_sample(ctx_yzl.src_imgs[v], px, py)
        wgt = fmath.exp(-torch.abs(ref_pix - ref_eval) / (2.0 * sc * sc))
        wr = wgt * ref_pix
        ws = wgt * src_pix
        terms = torch.stack([wr, wr * ref_pix, ws, ws * src_pix,
                             wr * src_pix, wgt], dim=1)     # [9, 6, A, H, W]
        sums = terms[0]
        for k in range(1, 9):
            sums = sums + terms[k]
        inv = 1.0 / torch.clamp(sums[5], min=1e-30)
        m_r, m_r2 = sums[0] * inv, sums[1] * inv
        m_s, m_s2 = sums[2] * inv, sums[3] * inv
        m_rs = sums[4] * inv
        var_r = m_r2 - m_r * m_r
        var_s = m_s2 - m_s * m_s
        cov = m_rs - m_r * m_s
        ncc = cov / torch.clamp(fmath.sqrt(torch.clamp(var_r * var_s,
                                                       min=0.0)), min=1e-30)
        c = torch.clamp(1.0 - ncc, 0.0, COST_MAX)
        c = torch.where((var_r < _K_MIN_VAR) | (var_s < _K_MIN_VAR),
                        torch.full_like(c, COST_MAX), c)
        # in-view anchors count (unselected ones as COST_MAX, the
        # reference's NaN quirk); out-of-view ones count COST_MAX only
        # where they see the view
        sees = sees_all[..., v]
        counted = anchors.valid & (in_view | sees)
        contrib = torch.where(in_view & sees, c, torch.full_like(c, COST_MAX))
        contrib = torch.where(counted, contrib, torch.zeros_like(c))
        acc = contrib[0]
        for a in range(1, A):
            acc = acc + contrib[a]
        cnt = torch.sum(counted.to(torch.int32), dim=0)
        strong = torch.clamp(acc / torch.clamp(cnt, min=1).to(torch.float32),
                             max=COST_MAX)
        cv = center[..., v]
        out.append(torch.where(cnt > 0, 0.25 * cv + 0.75 * strong, cv))
    return torch.stack(out, dim=-1)
