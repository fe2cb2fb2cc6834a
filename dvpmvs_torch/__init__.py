"""dvpmvs_torch — the PatchMatch MVS engine in PyTorch, with CUDA kernels
written by hand for Hopper (sm_90a).

A port of ``dvpmvs`` (the JAX/Pallas package beside it, which stays the
reference).  The layout mirrors ``dvpmvs``:

  geometry/  camera math: projections, plane<->depth, homographies
  kernels/   the hot path: bilateral-NCC cost (K1, csrc/ncc_fused.cu),
             checkerboard propagation, refinement, median filter, disparity
             sweeps (K2, csrc/sweep.cu), geometric consistency
             (K3, csrc/geom.cu), the weak-pixel machinery (anchors, RANSAC
             fit) and its anchor term (K4, csrc/anchor.cu), the warped
             source field of the "warp" cost backend (K5, csrc/warp.cu),
             plus the kernels' build and load step (_build.py)
  bench/     the gather microbenchmark (K6, csrc/gather_bench.cu)
  priors/    the Canny depth-edge prior (host numpy/scipy)
  engine/    the per-view PatchMatch pass
  utils/     synthetic scenes
  rng.py     the draw source every random draw goes through
  convert.py carries the JAX package's values (as numpy) into this package

Each kernel has a plain PyTorch version in the same module.  A wrapper runs
the plain version for tensors on the CPU and launches the kernel for tensors
on the card; it never falls back.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Geometry (homographies, reprojection) needs true f32 contractions; TF32
# keeps ~3 decimal digits and would corrupt sub-pixel coordinates.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Raises when the card is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
