"""K4: slot-exact anchor terms of the weak-pixel cost (counterpart of
``dvpmvs/kernels/anchor_pallas.py::anchor_slot_costs_pallas`` and
``anchor_slot_costs_from_ctx``, single-tap and sparse-patch tap modes).

``anchor_slot_costs`` evaluates the anchor term of S slot planes at K
compacted weak pixels for V views in one launch of ``csrc/anchor.cu`` for
tensors on the card, or in ``anchor_slot_costs_plain`` (the same function in
plain PyTorch: ``deformable.anchor_term_from_q`` slot by slot) for tensors on
the CPU.  With ``tap_words`` (``deformable.gather_tap_words``) each anchor
adds its sparse-patch taps to its group; the launch then counts under
``anchor/taps`` in ``_build.MODE_LAUNCHES``.  The sources are the fp32
images of the cost context, where the TPU kernel reads u8 packed quads.
"""

from __future__ import annotations


import torch

from .deformable import (AnchorCostTerm, AnchorFields, anchor_term_from_q,
                         slot_q)
from .ncc_fused import _mats

_NAME = "anchor"


def _usable_bits(vbits: torch.Tensor, V: int) -> torch.Tensor:
    """[A, K] int32 view bitmask -> [V, A, K] bool."""
    return torch.stack([((vbits >> v) & 1).to(torch.bool) for v in range(V)])


def anchor_slot_costs_plain(src, M, b, src_wh, q, rax, ray, ref_a, w_col,
                            vbits, tap_words=None, inv_f=None
                            ) -> AnchorCostTerm:
    """The plain version of K4: same arguments, same result."""
    bits = _usable_bits(vbits, src.shape[0])
    terms = [anchor_term_from_q(src, M, b, src_wh, q[s], rax, ray, ref_a,
                                w_col, bits, tap_words, inv_f)
             for s in range(q.shape[0])]
    return AnchorCostTerm(cost=torch.stack([t.cost for t in terms]),
                          has_anchors=torch.stack([t.has_anchors
                                                   for t in terms]))


def anchor_slot_costs(src, M, b, src_wh, q, rax, ray, ref_a, w_col, vbits,
                      tap_words=None, inv_f=None) -> AnchorCostTerm:
    """Anchor terms of S slots at K pixels: cost and has [S, K, V].

    src [V, H, W] fp32 sources; M [V, 3, 3], b [V, 3] the homography terms;
    src_wh [V, 2]; q [S, K, 3] the slot planes as n / w; rax, ray, ref_a,
    w_col [A, K] the anchor fields; vbits [A, K] int32, bit v set where the
    anchor is valid and sees view v (V <= 32); tap_words [V, n_extra, A, K]
    int32 (n_extra 1 or 2) with inv_f [2] (1/fx, 1/fy of the reference) for
    the tap mode."""
    V, H, W = src.shape
    S, K, three = q.shape
    A = rax.shape[0]
    if three != 3 or any(tuple(t.shape) != (A, K)
                         for t in (ray, ref_a, w_col, vbits)):
        raise ValueError("anchor_slot_costs: inconsistent shapes q "
                         f"{tuple(q.shape)} rax {tuple(rax.shape)}")
    if V > 32:
        raise ValueError("anchor_slot_costs: at most 32 views")
    if vbits.dtype != torch.int32:
        raise ValueError("anchor_slot_costs: vbits must be int32")
    n_extra = 0
    if tap_words is not None:
        n_extra = tap_words.shape[1]
        if (tap_words.dtype != torch.int32 or not 1 <= n_extra <= 2
                or tuple(tap_words.shape) != (V, n_extra, A, K)
                or inv_f is None):
            raise ValueError("anchor_slot_costs: tap_words must be int32 "
                             f"[{V}, 1 or 2, {A}, {K}] with inv_f, got "
                             f"{tuple(tap_words.shape)}")
    return anchor_slot_costs_plain(src, M, b, src_wh, q, rax, ray, ref_a,
                                   w_col, vbits, tap_words, inv_f)


def kernel_args(ctx, slot_planes_k: torch.Tensor, af: AnchorFields,
                ok_k=None, tap_words=None) -> tuple:
    """The arguments of ``anchor_slot_costs`` from a cost context, slot
    planes [S, K, 4] and compacted AnchorFields; ``ok_k`` [K] marks real
    compacted pixels (fill entries get no usable anchor); ``tap_words``
    [V, n_extra, A, K] switches on the tap mode."""
    V = ctx.num_views
    sees_bits = torch.zeros(af.sees.shape[1:], dtype=torch.int32,
                            device=af.sees.device)
    for v in range(V):
        sees_bits = sees_bits | (af.sees[v].to(torch.int32) << v)
    vbits = torch.where(af.valid, sees_bits, torch.zeros_like(sees_bits))
    if ok_k is not None:
        vbits = torch.where(ok_k[None], vbits, torch.zeros_like(vbits))
    inv_f = None if tap_words is None else (ctx.inv_fx, ctx.inv_fy)
    return (ctx.src_imgs, ctx.M, ctx.b, ctx.src_wh, slot_q(slot_planes_k),
            af.rax, af.ray, af.ref_a, af.w_col, vbits, tap_words, inv_f)


def anchor_slot_costs_from_ctx(ctx, slot_planes_k: torch.Tensor,
                               af: AnchorFields, ok_k=None, tap_words=None
                               ) -> AnchorCostTerm:
    """The contract of ``deformable.anchor_cost_term_for_plane`` over the
    slot axis: slot_planes_k [S, K, 4] -> cost and has [S, K, V]."""
    return anchor_slot_costs(*kernel_args(ctx, slot_planes_k, af, ok_k,
                                          tap_words))
