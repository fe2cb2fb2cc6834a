"""PatchMatch per-view state (counterpart of ``dvpmvs/engine/state.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PMState:
    """Per-view optimization state (the reference's per-pixel device
    arrays, APD.cpp:1497-1613):
      plane        [H, W, 4]   (n_ref, w) compute-form hypotheses
      cost         [H, W]      current aggregated matching cost
      sel_views    [H, W, V]   bool selected-view set
      view_weights [H, W, V]   MHJVS Monte-Carlo view weights
      weak         [H, W]      int8 PixelState
      radius       [H, W]      adaptive NCC radius (0 = default)
    """

    plane: torch.Tensor
    cost: torch.Tensor
    sel_views: torch.Tensor
    view_weights: torch.Tensor
    weak: torch.Tensor
    radius: torch.Tensor

    def replace(self, **kw) -> "PMState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class PassOutput:
    """Results of one PatchMatch pass in persistence form."""

    depth: torch.Tensor          # [H, W]
    normal_world: torch.Tensor   # [H, W, 3]
    cost: torch.Tensor           # [H, W]
    weak: torch.Tensor           # [H, W] int8
    sel_views: torch.Tensor      # [H, W, V] bool
    view_weights: torch.Tensor   # [H, W, V]
    radius: torch.Tensor         # [H, W]
