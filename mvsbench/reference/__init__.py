"""The plain reference of the benchmark: a frozen copy of the PatchMatch
pass of ``dvpmvs_torch`` (its plain PyTorch path) as of commit 3b5ba0b.

Copied so that the yardstick stays fixed while the program changes:
``config``, ``fmath``, ``rng``, ``geometry/``, ``engine/``, the plain
half of ``kernels/`` and ``priors/edges.py``.  Every kernel wrapper here
runs its plain PyTorch version on every device (the program launches its
CUDA kernel on the card), connected components come from scipy (the
program's native labeler gives the same labels), and ``view_pass.py``
holds the scene runner's per-view preparation.  Nothing here imports the
program.  A change to the program that changes its results changes what
the benchmark's comparison reads; this copy is not to be edited to follow
it.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Geometry (homographies, reprojection) needs true f32 contractions; TF32
# keeps ~3 decimal digits and would corrupt sub-pixel coordinates.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
# The mono prior's bf16 products accumulate in float32, as XLA's do.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Raises when the card is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
