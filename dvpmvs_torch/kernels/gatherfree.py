"""Leading-axis selection (counterpart of ``dvpmvs/kernels/gatherfree.py``).

The TPU needed a where-chain because its gathers are slow; on the GPU (and
the CPU) ``torch.gather`` is the natural form and selects the same values.
"""

from __future__ import annotations

import torch


def take0(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack[idx] along axis 0: stack [K, *S, *T], idx [*S] -> [*S, *T]."""
    extra = stack.dim() - 1 - idx.dim()
    ix = idx.to(torch.int64).reshape((1,) + tuple(idx.shape) + (1,) * extra)
    ix = ix.expand((1,) + tuple(stack.shape[1:]))
    return torch.gather(stack, 0, ix)[0]
