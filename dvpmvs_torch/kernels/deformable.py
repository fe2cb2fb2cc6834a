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
(``anchor_fused.py``).  The sparse-patch tap mode (``anchor_taps > 1``), the
candidate-independent warp-field variant and the exact 9-tap oracle are not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ncc import COST_MAX, CostContext, _guard, bilinear_sample
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


def anchor_fields_at(ctx: CostContext, anchors: AnchorResult,
                     sel_views: torch.Tensor, ref_img: torch.Tensor,
                     sigma_color, pk, gidx: torch.Tensor) -> AnchorFields:
    """AnchorFields at compacted evaluation-grid indices ``gidx`` [K] into
    the flattened grid that ``pk(arr, axis)`` packs to (one checkerboard
    color, or the identity for the full grid)."""
    H, W = ref_img.shape
    V = ctx.num_views
    gidx = gidx.to(torch.int64)
    flatk = lambda x: x.reshape(x.shape[0], -1)[:, gidx]
    ax = flatk(pk(torch.clamp(anchors.coords[..., 0], 0, W - 1), 1))
    ay = flatk(pk(torch.clamp(anchors.coords[..., 1], 0, H - 1), 1))
    valid = flatk(pk(anchors.valid, 1))
    idx = (ay * W + ax).to(torch.int64)
    ref_a = ref_img.reshape(-1)[idx]
    ref_c = pk(ref_img, 0).reshape(-1)[gidx]
    sc = torch.as_tensor(sigma_color, dtype=torch.float32,
                         device=ref_img.device)
    w_col = torch.exp(-torch.abs(ref_a - ref_c[None]) / (2.0 * sc * sc))
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
                       usable_bits) -> AnchorCostTerm:
    """The anchor term of one slot: q [*P, 3] per evaluated pixel; rax, ray,
    ref_a, w_col [A, *P]; usable_bits [V, A, *P] (valid & sees).  Returns
    cost and has [*P, V].

    Accumulates anchor by anchor in anchor order and group by group, and
    forms each product as JAX's expression does (w * r^2, (w * r) * s):
    K4 does the same operations in the same order."""
    V = src.shape[0]
    A = rax.shape[0]
    G = max(A // _MIN_ANCHOR_SAMPLES, 1)
    Ag = -(-A // G)
    q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
    f = lambda x: x.to(torch.float32)
    costs, hass = [], []
    for v in range(V):
        m = M[v]
        bv = b[v]
        use_a, oov_a, src_a = [], [], []
        for a in range(A):
            ra, ya = rax[a], ray[a]
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
            src_a.append(bilinear_sample(src[v], px, py))
            use_a.append(usable_bits[v, a] & in_view)
            oov_a.append(usable_bits[v, a] & ~in_view)
        c_num = n_sum = None
        for g in range(G):
            members = range(g * Ag, min((g + 1) * Ag, A))
            c0 = ref_a[g * Ag]
            sw = n_g = s_r = s_r2 = s_s = s_s2 = s_rs = None
            for a in members:
                w = torch.where(use_a[a], w_col[a], torch.zeros_like(
                    w_col[a]))
                r = ref_a[a] - c0
                s = src_a[a] - c0
                terms = (w, f(use_a[a]), w * r, w * (r * r), w * s,
                         w * (s * s), w * r * s)
                if sw is None:
                    sw, n_g, s_r, s_r2, s_s, s_s2, s_rs = terms
                else:
                    sw, n_g, s_r, s_r2, s_s, s_s2, s_rs = (
                        x + t for x, t in zip(
                            (sw, n_g, s_r, s_r2, s_s, s_s2, s_rs), terms))
            inv = 1.0 / torch.clamp(sw, min=1e-30)
            m_ref = s_r * inv
            m_ref2 = s_r2 * inv
            m_src = s_s * inv
            m_src2 = s_s2 * inv
            m_rs = s_rs * inv
            var_r = m_ref2 - m_ref * m_ref
            var_s = m_src2 - m_src * m_src
            cov = m_rs - m_ref * m_src
            ncc = cov / torch.clamp(torch.sqrt(torch.clamp(var_r * var_s,
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
        n_use = f(use_a[0])
        n_oov = f(oov_a[0])
        for a in range(1, A):
            n_use = n_use + f(use_a[a])
            n_oov = n_oov + f(oov_a[a])
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
                               af: AnchorFields) -> AnchorCostTerm:
    """Candidate-dependent anchor term of one slot's plane field
    [*P, 4] at the evaluated pixels of ``af`` (exact homography semantics,
    one sample per anchor center): cost and has [*P, V]."""
    return anchor_term_from_q(
        ctx.src_imgs, ctx.M, ctx.b, ctx.src_wh, slot_q(plane_field),
        af.rax, af.ray, af.ref_a, af.w_col, af.valid[None] & af.sees)
