"""Carry the JAX package's values across into this package.

The functions take plain numpy arrays, dicts, or any object with the named
attributes (such as a JAX ``Camera`` or ``PassOutput``, read through
``numpy.asarray``), and return this package's objects on ``device`` (the
card unless the caller asks for another).  The tests use them to start a
port pass from a JAX pass's output; nothing on the card path does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from . import resolve_device
from .config import PMDynamic, PMStatic, RunState
from .engine.state import PassOutput
from .geometry.camera import Camera
from .kernels.weak import AnchorResult

_BACKENDS = {"pallas": "fused", "exact": "exact", "fused": "fused",
             "warp": "warp"}


def _get(src: Any, name: str):
    if isinstance(src, Mapping):
        return src[name]
    return getattr(src, name)


def _fields(src: Any, names):
    if isinstance(src, Mapping):
        return {k: src[k] for k in names if k in src}
    return {k: getattr(src, k) for k in names if hasattr(src, k)}


def camera(src: Any, device=None) -> Camera:
    """K, R, t, depth_min, depth_max (any leading view axis) -> Camera."""
    dev = resolve_device(device)
    return Camera.create(
        *(np.array(_get(src, k), np.float32)
          for k in ("K", "R", "t", "depth_min", "depth_max")), device=dev)


def static_params(src: Any) -> PMStatic:
    """PMStatic fields -> PMStatic; cost_backend "pallas" maps to "fused".
    Fields the port does not have are dropped."""
    kw = _fields(src, [f.name for f in dataclasses.fields(PMStatic)])
    if "state" in kw:
        kw["state"] = RunState(int(kw["state"]))
    if "cost_backend" in kw:
        backend = str(kw["cost_backend"])
        if backend not in _BACKENDS:
            raise ValueError(f"cost_backend {backend!r} has no counterpart "
                             "in the port")
        kw["cost_backend"] = _BACKENDS[backend]
    return PMStatic(**kw)


def dynamic_params(src: Any) -> PMDynamic:
    """PMDynamic fields (scalars or 0-d arrays) -> PMDynamic."""
    kw = _fields(src, [f.name for f in dataclasses.fields(PMDynamic)])
    return PMDynamic.create(**{k: float(np.asarray(v)) for k, v in
                               kw.items()})


def anchors(src: Any, device=None) -> AnchorResult:
    """coords, valid, reliable (an AnchorResult of either package) ->
    AnchorResult."""
    dev = resolve_device(device)
    t = lambda k, dt: torch.as_tensor(np.asarray(_get(src, k)), device=dev
                                      ).to(dt)
    return AnchorResult(coords=t("coords", torch.int32),
                        valid=t("valid", torch.bool),
                        reliable=t("reliable", torch.bool))


def pass_output(src: Any, device=None) -> PassOutput:
    """depth, normal_world, cost, weak, sel_views, view_weights, radius and
    weak_overflow (where present and not None) -> PassOutput."""
    dev = resolve_device(device)
    t = lambda k, dt: torch.as_tensor(np.asarray(_get(src, k)), device=dev
                                      ).to(dt)
    over = _fields(src, ["weak_overflow"]).get("weak_overflow")
    return PassOutput(
        depth=t("depth", torch.float32),
        normal_world=t("normal_world", torch.float32),
        cost=t("cost", torch.float32),
        weak=t("weak", torch.int8),
        sel_views=t("sel_views", torch.bool),
        view_weights=t("view_weights", torch.float32),
        radius=t("radius", torch.float32),
        weak_overflow=None if over is None else t("weak_overflow",
                                                  torch.int32),
    )


def depth_anything_state_dict(params: Mapping) -> dict:
    """A Flax Depth-Anything-V2 ``params`` tree (numpy arrays, as JAX's
    ``init_params`` or ``convert_state_dict`` give it) -> the port's state
    dict (release keys, float32 CPU tensors) for ``load_state_dict``.

    Inverts JAX's converter (``dvpmvs/priors/convert.py``): Conv kernels
    [kh, kw, I, O] -> [O, I, kh, kw]; ConvTranspose kernels undo the
    spatial flip, then [kh, kw, I, O] -> [I, O, kh, kw]; Dense kernels
    [I, O] -> [O, I]; LayerNorm ``scale`` -> ``weight``.  refinenet4's
    resConfUnit1, which Flax never builds (it takes no skip), is zero."""
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    conv = lambda k: f32(np.transpose(np.asarray(k), (3, 2, 0, 1)))
    deconv = lambda k: f32(np.transpose(np.asarray(k)[::-1, ::-1],
                                        (2, 3, 0, 1)))
    lin = lambda k: f32(np.transpose(np.asarray(k)))
    sd = {}

    def layer(prefix, p, kernel=conv):
        sd[f"{prefix}.weight"] = kernel(p["kernel"])
        if "bias" in p:
            sd[f"{prefix}.bias"] = f32(p["bias"])

    def norm(prefix, p):
        sd[f"{prefix}.weight"] = f32(p["scale"])
        sd[f"{prefix}.bias"] = f32(p["bias"])

    bb, head = params["backbone"], params["head"]
    sd["pretrained.cls_token"] = f32(bb["cls_token"])
    sd["pretrained.pos_embed"] = f32(bb["pos_embed"])
    layer("pretrained.patch_embed.proj", bb["patch_embed"])
    norm("pretrained.norm", bb["norm"])
    blocks = sorted(int(k[5:]) for k in bb if k.startswith("block"))
    for i in blocks:
        b, p = bb[f"block{i}"], f"pretrained.blocks.{i}"
        norm(f"{p}.norm1", b["norm1"])
        layer(f"{p}.attn.qkv", b["attn"]["qkv"], lin)
        layer(f"{p}.attn.proj", b["attn"]["proj"], lin)
        sd[f"{p}.ls1.gamma"] = f32(b["ls1"])
        norm(f"{p}.norm2", b["norm2"])
        layer(f"{p}.mlp.fc1", b["mlp_fc1"], lin)
        layer(f"{p}.mlp.fc2", b["mlp_fc2"], lin)
        sd[f"{p}.ls2.gamma"] = f32(b["ls2"])

    for i in range(4):
        layer(f"depth_head.projects.{i}", head[f"project{i}"])
        layer(f"depth_head.scratch.layer{i + 1}_rn", head[f"layer{i + 1}_rn"])
    layer("depth_head.resize_layers.0", head["resize0"], deconv)
    layer("depth_head.resize_layers.1", head["resize1"], deconv)
    layer("depth_head.resize_layers.3", head["resize3"])
    for r in range(1, 5):
        blk, p = head[f"refinenet{r}"], f"depth_head.scratch.refinenet{r}"
        layer(f"{p}.out_conv", blk["out_conv"])
        for u in (1, 2):
            for c in ("conv1", "conv2"):
                if f"resConfUnit{u}" in blk:
                    layer(f"{p}.resConfUnit{u}.{c}", blk[f"resConfUnit{u}"][c])
                else:
                    f = np.asarray(blk["out_conv"]["kernel"]).shape[-1]
                    sd[f"{p}.resConfUnit{u}.{c}.weight"] = torch.zeros(
                        f, f, 3, 3)
                    sd[f"{p}.resConfUnit{u}.{c}.bias"] = torch.zeros(f)
    layer("depth_head.scratch.output_conv1", head["output_conv1"])
    layer("depth_head.scratch.output_conv2.0", head["output_conv2a"])
    layer("depth_head.scratch.output_conv2.2", head["output_conv2b"])
    return sd
