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

_BACKENDS = {"pallas": "fused", "exact": "exact", "fused": "fused"}


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


def pass_output(src: Any, device=None) -> PassOutput:
    """depth, normal_world, cost, weak, sel_views, view_weights, radius ->
    PassOutput."""
    dev = resolve_device(device)
    t = lambda k, dt: torch.as_tensor(np.asarray(_get(src, k)), device=dev
                                      ).to(dt)
    return PassOutput(
        depth=t("depth", torch.float32),
        normal_world=t("normal_world", torch.float32),
        cost=t("cost", torch.float32),
        weak=t("weak", torch.int8),
        sel_views=t("sel_views", torch.bool),
        view_weights=t("view_weights", torch.float32),
        radius=t("radius", torch.float32),
    )
