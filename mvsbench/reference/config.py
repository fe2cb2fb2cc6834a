"""Configuration layer (counterpart of ``dvpmvs/config.py``).

``PMStatic`` holds the shape- and control-flow-affecting parameters,
``PMDynamic`` the arithmetic-only scalars (plain floats here: PyTorch runs
eagerly, so nothing is recompiled when they change).
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Tuple

import numpy as np

COST_BACKENDS = ("exact", "fused", "warp")


class RunState(IntEnum):
    """Pass modes (reference: ``RunState``, main.h:74-78)."""

    FIRST_INIT = 0
    REFINE_INIT = 1
    REFINE_ITER = 2


class PixelState(IntEnum):
    """Per-pixel classification (reference: ``PixelState``, main.h:80-84)."""

    WEAK = 0
    STRONG = 1
    UNKNOWN = 2


@dataclasses.dataclass(frozen=True)
class PMStatic:
    """Shape- and control-flow-affecting PatchMatch parameters.

    Same fields and defaults as ``dvpmvs.config.PMStatic``.  ``cost_backend``
    is ``"exact"`` (per-center-plane window warp in plain PyTorch, constant-
    plane sweeps), ``"fused"`` (the counterpart of JAX's ``"pallas"``: the
    NCC kernel for every candidate batch, and the sweep and geom kernels for
    the disparity sweeps of a pass without a radius map) or ``"warp"`` (JAX's
    warp mode: one warped source field per plane, from the warp-field
    kernel, read at 36 static shifts; full grid, constant-plane sweeps).
    Every backend runs on either device; on the CPU every kernel is replaced
    by its plain version.  ``anchor_taps`` is 1 (anchor centers) to 3 (two
    sparse-patch taps per anchor, each a 16-bit half of one int32 word)."""

    state: RunState = RunState.FIRST_INIT
    num_src: int = 0
    max_iterations: int = 3
    top_k: int = 4
    strong_radius: int = 5
    strong_increment: int = 2
    weak_radius: int = 5
    weak_increment: int = 5
    rotate_time: int = 4
    geom_consistency: bool = False
    use_APD: bool = False
    use_edge: bool = True
    use_limit: bool = True
    use_label: bool = True
    use_detail: bool = False
    use_radius: bool = True
    view_samples: int = 15
    max_views: int = 32
    neighbour_num: int = 12
    extend_rounds: int = 3
    exact_deformable: bool = False
    anchor_taps: int = 1
    weak_budget_frac: float = 0.5
    debug_dumps: bool = False
    cost_backend: str = "exact"

    def __post_init__(self):
        if self.cost_backend not in COST_BACKENDS:
            raise ValueError(f"cost_backend must be one of {COST_BACKENDS}, "
                             f"got {self.cost_backend!r}")
        if not 1 <= self.anchor_taps <= 3:
            raise ValueError(f"anchor_taps must be 1, 2 or 3, got "
                             f"{self.anchor_taps}")

    def replace(self, **kw) -> "PMStatic":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PMDynamic:
    """Arithmetic-only PatchMatch parameters (float32-valued floats)."""

    depth_min: float = 0.0
    depth_max: float = 1.0
    sigma_spatial: float = 5.0
    sigma_color: float = 3.0
    geom_factor: float = 0.2
    ransac_threshold: float = 0.005
    weak_peak_radius: float = 6.0

    @classmethod
    def create(cls, **kw) -> "PMDynamic":
        # every value, defaults included, is rounded to float32, as the JAX
        # package stores them
        vals = dataclasses.asdict(cls())
        vals.update(kw)
        return cls(**{k: float(np.float32(v)) for k, v in vals.items()})

    def replace(self, **kw) -> "PMDynamic":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SceneConfig:
    """Host-side schedule options: the fields of ``dvpmvs.config.SceneConfig``
    that ``SceneRunner`` reads, with their defaults.  ``mesh_views`` above
    1 runs each pass as one batch of all views, split over the ranks of the
    runner's process group (in one process when it has none);
    ``mesh_tiles`` above 1 row-tiles each view pass over the group's ranks
    (untiled with no group, with ``mesh_views`` above 1, or where the
    height does not divide)."""

    output_folder: str = ""            # where show_medium_result writes
    max_base_size: int = 800           # pyramid: halve until maxdim <= this
    geometric_passes: int = 3          # geometric passes per round
    show_medium_result: bool = False   # per-pass jpgs (main.cpp:396-403)
    full_res_round: bool = False       # add the full-resolution round the
                                       # reference never runs (main.cpp:450)
    seed: int = 0
    mesh_views: int = 1                # devices along the view axis
    mesh_tiles: int = 1                # devices along the image-row axis


# Reference schedule (main.cpp:450-512), as dvpmvs.config.round_pass_params.
def round_pass_params(
    round_idx: int,
    num_rounds: int,
    pass_idx: int,
    base_static: PMStatic,
    depth_min: float,
    depth_max: float,
) -> Tuple[PMStatic, PMDynamic]:
    """(static, dynamic) params for (round, pass); ``pass_idx`` 0 is the
    photometric pass, >= 1 a geometric one."""
    i = round_idx
    st = base_static
    ransac_threshold = 0.01 - i * 0.00125
    weak_peak_radius = 6.0
    if pass_idx == 0:
        if i == 0:
            ransac_threshold = 0.005
            st = st.replace(state=RunState.FIRST_INIT, use_APD=False,
                            geom_consistency=False)
        else:
            st = st.replace(
                state=RunState.REFINE_INIT,
                use_APD=True,
                rotate_time=min(2 ** i, 4),
                use_detail=(i < num_rounds - 1),
                geom_consistency=False,
            )
    else:
        j = pass_idx - 1
        weak_peak_radius = float(max(4 - 2 * j, 2))
        st = st.replace(
            state=RunState.REFINE_ITER,
            use_APD=(i > 0),
            rotate_time=min(2 ** i, 4) if i > 0 else base_static.rotate_time,
            geom_consistency=True,
        )
    dyn = PMDynamic.create(
        depth_min=depth_min,
        depth_max=depth_max,
        ransac_threshold=ransac_threshold,
        weak_peak_radius=weak_peak_radius,
    )
    return st, dyn


def num_rounds_for(width: int, height: int, max_base_size: int = 800) -> int:
    """Pyramid round count (reference ``ComputeRoundNum``, main.cpp:248-264)."""
    max_size = max(width, height)
    rounds = 1
    while max_size > max_base_size:
        max_size //= 2
        rounds += 1
    return rounds
