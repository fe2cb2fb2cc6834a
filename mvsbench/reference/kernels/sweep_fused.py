"""K2: the disparity-sweep kernel (counterpart of
``dvpmvs/kernels/sweep_pallas.py::sweep_weighted_ncc``).

The K-step sweeps of DepthToWeak (K = 61) and LocalRefine (K = 11) keep each
pixel's surface and step its disparity: d_k = fx*bl / (disp0 + k - k0).
Under warp-field semantics (PARITY.md deviation 2) tap pixel q reads source
v at q's own ray and inverse depth invd0(q) + (k - k0) * invbl(q), so the
homogeneous source coordinates are linear in k and all 36 taps are static
offsets of one warped field per (v, k).  The views are folded with per-pixel
weights into [K, H, W] = sum_v vw_v * cost_v.

Border semantics: a tap past the image border reads the warped field of the
nearest border pixel (edge replication at the true border).  The JAX kernel
edge-replicates its zero-padded 16x256 tile multiple instead, so the two
differ within the window radius of the right and bottom borders.  A row
window of the tiled pass (``y0``, the image row of the output's first row)
takes the per-pixel inputs of its rows and invd0, invbl whole: its halo
reads the real neighbouring rows, and only the image border replicates.

``sweep_weighted_ncc`` launches ``csrc/sweep.cu`` for tensors on the card
and runs ``sweep_weighted_ncc_plain`` for tensors on the CPU.  The kernel
rounds every operation as the plain version does and agrees with it
bitwise (``chip_smoke.py`` holds it to 5e-3 except on 1e-3 of the entries;
``tests/test_torch_kernel_model.py`` shows why it may not round otherwise).
"""

from __future__ import annotations


import numpy as np
import torch

from .. import fmath
from .ncc import (COST_MAX, _K_MIN_VAR, _TAP_AXIS, _bilinear_sample_batch,
                  _grid, _guard, tap_moments)
from .ncc_fused import _mats

_NAME = "sweep"
MAX_HALO = 8        # the kernel's radii: 0..8, each its own instantiation
MAX_VIEWS = 32      # the views' M, b staged in shared memory


def tap_offsets(radius: int) -> np.ndarray:
    """[2, 36] int32 (dy, dx) static tap offsets, tap_grid order."""
    offs = [int(round(float(a) * radius)) for a in _TAP_AXIS]
    dy = [o for o in offs for _ in offs]
    dx = [o for _ in offs for o in offs]
    return np.asarray([dy, dx], np.int32)


def sweep_weighted_ncc_plain(invd0, invbl, vweights, w_taps, wref_taps, wsums,
                             src, M, b, cam, src_wh, K: int, k0: int,
                             radius: int = 5, y0: int = 0):
    """The plain version of K2: same arguments, same result [K, Ho, W].
    The warped field is formed on the output rows and their halo only."""
    H, W = invd0.shape
    Ho = wsums.shape[1]
    dev = invd0.device
    offs = torch.as_tensor(tap_offsets(radius), device=dev, dtype=torch.long)
    halo = int(offs.abs().max())
    r0, r1 = max(y0 - halo, 0), min(y0 + Ho + halo, H)   # field rows
    invd0, invbl = invd0[r0:r1], invbl[r0:r1]
    xs, ys = _grid(r1 - r0, W, dev)
    ys = ys + float(r0)
    rx = (xs - cam[0]) / cam[2]
    ry = (ys - cam[1]) / cam[3]
    e = lambda a: a[:, None, None]
    mr = [e(M[:, i, 0]) * rx + e(M[:, i, 1]) * ry + e(M[:, i, 2])
          for i in range(3)]                                   # [V, H, W]
    inv = 1.0 / torch.clamp(wsums[0], min=1e-30)
    m_ref = wsums[1] * inv
    var_ref = wsums[2] * inv - m_ref * m_ref
    ref_bad = var_ref < _K_MIN_VAR
    iy = torch.clamp(torch.arange(y0, y0 + Ho, device=dev)[None, :, None]
                     + offs[0][:, None, None], 0, H - 1) - r0  # [T, Ho, 1]
    ix = torch.clamp(torch.arange(W, device=dev)[None, None, :]
                     + offs[1][:, None, None], 0, W - 1)       # [T, 1, W]
    sw = e(src_wh[:, 0])
    sh = e(src_wh[:, 1])
    out = []
    for k in range(K):
        invd = invd0 + float(k - k0) * invbl
        hx = mr[0] + e(b[:, 0]) * invd
        hy = mr[1] + e(b[:, 1]) * invd
        hz = mr[2] + e(b[:, 2]) * invd
        hzs = _guard(hz)
        pxu = hx / hzs
        pyu = hy / hzs
        field = _bilinear_sample_batch(src, pxu, pyu)          # [V, H, W]
        taps = field[:, iy, ix]                                # [V, T, H, W]
        s1, s2, s3 = tap_moments(taps, w_taps, wref_taps)
        m_src = s1 * inv
        var_src = s2 * inv - m_src * m_src
        covar = s3 * inv - m_ref * m_src
        var_prod = fmath.sqrt(torch.clamp(var_ref * var_src, min=0.0))
        ncc = covar / torch.clamp(var_prod, min=1e-30)
        cost = torch.clamp(1.0 - ncc, 0.0, COST_MAX)
        in_view = (pxu >= 0) & (pxu < sw) & (pyu >= 0) & (pyu < sh) & (hz > 0)
        bad = ref_bad | (var_src < _K_MIN_VAR) | ~in_view[:, y0 - r0:
                                                          y0 - r0 + Ho]
        cost = torch.where(bad, torch.full_like(cost, COST_MAX), cost)
        acc = vweights[0] * cost[0]
        for v in range(1, cost.shape[0]):      # view order, as the kernel
            acc = acc + vweights[v] * cost[v]
        out.append(acc)
    return torch.stack(out)


def sweep_weighted_ncc(invd0, invbl, vweights, w_taps, wref_taps, wsums, src,
                       M, b, cam, src_wh, K: int, k0: int, radius: int = 5,
                       y0: int = 0):
    """Weighted NCC costs of the K-step sweep (steps k - k0) -> [K, Ho, W].

    invd0 [H, W] inverse depth at step k0; invbl [H, W] 1/(fx*baseline) (0 =
    no motion); vweights [V, Ho, W] fold weights; w_taps, wref_taps
    [36, Ho, W]; wsums [3, Ho, W]; src [V, H, W] fp32; M [V, 3, 3]; b [V, 3];
    cam [4] (cx, cy, fx, fy); src_wh [V, 2]; radius the static window; the
    Ho output rows are image rows y0 .. y0 + Ho - 1 (the whole image by
    default)."""
    H, W = invd0.shape
    V = src.shape[0]
    Ho = wsums.shape[1] if wsums.dim() == 3 else -1
    if invbl.shape != (H, W) or vweights.shape != (V, Ho, W) or \
            w_taps.shape != (36, Ho, W) or wsums.shape != (3, Ho, W) or \
            tuple(src.shape[1:]) != (H, W) or not 0 <= y0 <= H - Ho:
        raise ValueError("sweep_weighted_ncc: inconsistent shapes")
    return sweep_weighted_ncc_plain(invd0, invbl, vweights, w_taps,
                                    wref_taps, wsums, src, M, b, cam,
                                    src_wh, K, k0, radius, y0)


def sweep_weighted_from_ctx(ctx, depth, baseline, fx, vweights, K: int,
                            k0: int) -> torch.Tensor:
    """[K, H', W] weighted NCC sums for the sweep around ``depth``.

    ``ctx`` is a CostContext with the static window, on the whole grid or
    on the H' rows of a row window from ``ctx.y0``; ``depth`` and
    ``baseline`` are whole [H, W]; ``vweights`` [H', W, V] is view_weights
    * selected mask on the context's rows."""
    invd0 = 1.0 / torch.clamp(depth, min=1e-12)
    fxbl = fx * baseline
    invbl = torch.where(fxbl > 0, 1.0 / torch.clamp(fxbl, min=1e-12),
                        torch.zeros_like(fxbl))
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    return sweep_weighted_ncc(
        invd0.contiguous(), invbl.contiguous(),
        torch.movedim(vweights, -1, 0).contiguous(), ctx.w_taps.contiguous(),
        ctx.wref_taps.contiguous(), wsums, ctx.src_imgs, ctx.M, ctx.b,
        ctx.cam, ctx.src_wh, K=K, k0=k0, radius=ctx.strong_radius, y0=ctx.y0)
