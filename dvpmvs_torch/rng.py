"""The draw source: every random number of a pass comes through here.

PyTorch cannot reproduce ``jax.random``.  So each draw site names itself by
the JAX key path that feeds the same site in ``dvpmvs``, and asks a draw
source for uniform numbers at the full-grid shape that JAX's exact path
draws.  A caller that evaluates on the checkerboard-packed half grid packs
the draws afterwards, so the exact path, the packed path and both devices
consume the same numbers at every pixel that commits.

A key path is a tuple of steps from the pass key: ``("split", n, i)`` is
``jax.random.split(key, n)[i]`` and ``("fold_in", d)`` is
``jax.random.fold_in(key, d)``.  The draw sites of a pass
(engine/patchmatch.py) are:

  random depth   split(3)[0] / split(2)[0]                  (sampling.py:148)
  init normals   split(3)[0] / split(2)[1] / split(2)[0|1]  (transforms.py:150)
  MHJVS          split(3)[2] / fold_in(it) / fold_in(color) / split(2)[0]
  refinement     split(3)[2] / fold_in(it) / fold_in(color) / split(2)[1] /
                 split(5)[0..4]                              (refine.py:42-51)

``TorchDraws`` is the production source: one counter-based generator per
draw (Philox on the card), seeded from the run seed and the key path, so a
draw does not depend on the order of the others.  Tests supply a source that
derives the JAX keys and returns the JAX numbers.
"""

from __future__ import annotations

import hashlib
from typing import Protocol, Sequence, Tuple

import torch

KeyPath = Tuple[tuple, ...]


def split(path: KeyPath, num: int, index: int) -> KeyPath:
    """Key path of ``jax.random.split(key, num)[index]``."""
    return tuple(path) + (("split", int(num), int(index)),)


def fold_in(path: KeyPath, data: int) -> KeyPath:
    """Key path of ``jax.random.fold_in(key, data)``."""
    return tuple(path) + (("fold_in", int(data)),)


class DrawSource(Protocol):
    def uniform(self, path: KeyPath, shape: Sequence[int],
                minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
        """float32 uniform numbers in [minval, maxval) of ``shape``."""
        ...


class TorchDraws:
    """Production draw source on ``device`` (Philox on the card)."""

    def __init__(self, seed: int, device="cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _path_seed(self, path: KeyPath) -> int:
        digest = hashlib.blake2b(repr((self.seed, tuple(path))).encode(),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "little") & ((1 << 63) - 1)

    def uniform(self, path: KeyPath, shape: Sequence[int],
                minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._path_seed(path))
        u = torch.rand(tuple(shape), generator=gen, device=self.device,
                       dtype=torch.float32)
        return torch.clamp(u * (maxval - minval) + minval, min=minval)
