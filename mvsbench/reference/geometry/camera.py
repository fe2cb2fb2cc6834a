"""Camera model (counterpart of ``dvpmvs/geometry/camera.py``).

A camera is a dataclass of float32 tensors.  Fields may carry a leading view
axis ([V, ...]) for a stacked view set.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import fmath


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: x_cam = R @ X_world + t;  pixel = K @ x_cam (dehom.)."""

    K: torch.Tensor          # [..., 3, 3]
    R: torch.Tensor          # [..., 3, 3]
    t: torch.Tensor          # [..., 3]
    depth_min: torch.Tensor  # [...]
    depth_max: torch.Tensor  # [...]

    @property
    def c(self) -> torch.Tensor:
        """Camera center in world coordinates: c = -R^T t."""
        return -fmath.rmatvec(self.R, self.t)

    @property
    def fx(self) -> torch.Tensor:
        return self.K[..., 0, 0]

    @property
    def fy(self) -> torch.Tensor:
        return self.K[..., 1, 1]

    @property
    def cx(self) -> torch.Tensor:
        return self.K[..., 0, 2]

    @property
    def cy(self) -> torch.Tensor:
        return self.K[..., 1, 2]

    @property
    def device(self) -> torch.device:
        return self.K.device

    @classmethod
    def create(cls, K, R, t, depth_min=0.0, depth_max=1.0,
               device="cpu") -> "Camera":
        f = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        return cls(K=f(K), R=f(R), t=f(t),
                   depth_min=f(depth_min), depth_max=f(depth_max))

    def to(self, device) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})


def stack_cameras(cams: Sequence[Camera]) -> Camera:
    """Stack single cameras into a view-batched Camera ([V, ...] leading)."""
    return Camera(**{f.name: torch.stack([getattr(c, f.name) for c in cams])
                     for f in dataclasses.fields(Camera)})


def scale_camera(cam: Camera, scale_x: float, scale_y: float) -> Camera:
    """Rescale intrinsics for a resized image (reference APD.cpp:1139-1143).

    Only fx,cx (by scale_x) and fy,cy (by scale_y) change; the products are
    taken in float32 numpy, as ``dvpmvs.geometry.camera.scale_camera`` does.
    """
    K = cam.K.cpu().numpy().copy()
    K[..., 0, 0] *= scale_x
    K[..., 0, 2] *= scale_x
    K[..., 1, 1] *= scale_y
    K[..., 1, 2] *= scale_y
    return dataclasses.replace(cam, K=torch.as_tensor(K, device=cam.device))
