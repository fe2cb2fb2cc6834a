"""The port's kernels against their plain versions on the card.

Needs an NVIDIA GPU, nvcc and nothing of JAX; without a card each test
skips.  On a machine without JAX, run it without the repository's
conftest (which sets up JAX for the other tests):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

The kernels are built without multiply-add contraction and accumulate in
their plain versions' order, so they agree bitwise at these shapes; the
bound allows a last-bit difference at 1e-3 of the entries.
"""

import numpy as np
import pytest
import torch

from dvpmvs_torch.engine.packing import pack_ctx, pack_parity
from dvpmvs_torch.geometry import stack_cameras
from dvpmvs_torch.kernels import _build, geom_fused, ncc_fused, sweep_fused
from dvpmvs_torch.kernels.geom import build_geom_context
from dvpmvs_torch.kernels.ncc import _grid, build_cost_context
from dvpmvs_torch.kernels.sampling import plane_from_normal_depth
from dvpmvs_torch.utils.synthetic import make_scene

H, W, V = 48, 160, 2
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = make_scene(num_views=V + 1, height=H, width=W, seed=4)
    ref = scene.cameras[0].to(dev)
    src = stack_cameras(scene.cameras[1:]).to(dev)
    img = torch.as_tensor(scene.images, device=dev)
    rmap = torch.as_tensor(np.random.default_rng(0).uniform(
        3.0, 7.0, (H, W)).astype(np.float32), device=dev)
    xs, ys = _grid(H, W, dev)
    depth = torch.as_tensor(scene.gt_depth[0], device=dev)
    plane = plane_from_normal_depth(
        torch.as_tensor(scene.gt_normal[0], device=dev), depth, xs, ys, ref)
    planes = torch.stack([plane, plane * torch.tensor(
        [1.0, 1.0, 1.0, 1.1], device=dev)])
    return dict(dev=dev, scene=scene, ref=ref, src=src, img=img, rmap=rmap,
                depth=depth, planes=planes)


def _agree(got, want):
    assert got.shape == want.shape
    d = torch.abs(got - want)
    d = torch.where(torch.isnan(got) & torch.isnan(want),
                    torch.zeros_like(d), d)
    share = float((~(d <= 1e-3)).double().mean())
    assert share <= 1e-3, share


def _ncc_args(ctx, planes):
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    return (planes.contiguous(), ctx.w_taps.contiguous(),
            ctx.wref_taps.contiguous(), wsums, ctx.src_imgs, ctx.M, ctx.b,
            ctx.cam, ctx.src_wh)


@pytest.mark.parametrize("mode", ["dense", "radius_map", "parity0",
                                  "parity1"])
def test_ncc_kernel_matches_plain(card, mode):
    c = card
    ctx = build_cost_context(c["img"][0], c["img"][1:], c["ref"], c["src"],
                             5.0, 3.0, backend="fused",
                             radius_map=c["rmap"] if mode == "radius_map"
                             else None)
    planes, par = c["planes"], None
    if mode.startswith("parity"):
        par = int(mode[-1])
        ctx = pack_ctx(ctx, par)
        planes = pack_parity(planes, par, axis=1)
    args = _ncc_args(ctx, planes)
    kw = dict(radius_map=ctx.radius.contiguous() if ctx.has_radius_map
              else None, parity=par)
    before = _build.LAUNCHES["ncc_fused"]
    got = ncc_fused.fused_ncc_costs(*args, **kw)
    assert _build.LAUNCHES["ncc_fused"] == before + 1
    _agree(got, ncc_fused.fused_ncc_costs_plain(*args, **kw))


def test_sweep_kernel_matches_plain(card):
    c = card
    ctx = build_cost_context(c["img"][0], c["img"][1:], c["ref"], c["src"],
                             5.0, 3.0, backend="fused")
    invd0 = (1.0 / c["depth"]).contiguous()
    invbl = torch.full((H, W), 1.0 / (float(c["ref"].fx) * 0.3),
                       device=c["dev"])
    vw = torch.rand((V, H, W), generator=torch.Generator(
        device=c["dev"]).manual_seed(0), device=c["dev"])
    wsums = torch.stack([ctx.sum_w, ctx.sum_wref, ctx.sum_wref2])
    args = (invd0, invbl, vw, ctx.w_taps, ctx.wref_taps, wsums,
            ctx.src_imgs, ctx.M, ctx.b, ctx.cam, ctx.src_wh)
    got = sweep_fused.sweep_weighted_ncc(*args, K=9, k0=4)
    _agree(got, sweep_fused.sweep_weighted_ncc_plain(*args, K=9, k0=4))


@pytest.mark.parametrize("fold", [True, False])
def test_geom_kernel_matches_plain(card, fold):
    c = card
    src_depths = torch.as_tensor(c["scene"].gt_depth[1:], device=c["dev"])
    gctx = build_geom_context(src_depths, c["ref"], c["src"])
    ks = torch.linspace(0.9, 1.1, 5, device=c["dev"])
    dstack = (c["depth"][None] * ks[:, None, None]).contiguous()
    vw = torch.rand((H, W, V), generator=torch.Generator(
        device=c["dev"]).manual_seed(1), device=c["dev"])
    kw = dict(vweights=vw if fold else None, fold=fold)
    got = geom_fused.geom_cost(gctx, dstack, **kw)
    _agree(got, geom_fused.geom_cost_plain(gctx, dstack, **kw))
