"""Row windows of the row-tiled pass (``dist/tiles.py``).

A rank of the tiled pass owns rows [y0, y1) of an H-row image and keeps the
whole pass state.  Its heavy per-pixel stages compute a window of rows (its
own, plus a halo where a stage reads computed values of neighbouring rows)
against whole tensors read at absolute coordinates, and each stage ends with
an exchange that makes the committed rows whole again on every rank.

``Rows`` is what the caller gives ``run_pass``: the owned rows and the
exchange.  ``RowWindow`` is what the pass computes on: the compute rows are
(c0 + i) mod H for i in [0, hc), a cyclic range around the owned rows (the
warp backend's taps wrap at the image border, so the halo of the first rows
is the last rows); it is the whole image, in order, when the halo would
cover it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rows [y0, y1) this rank owns, and ``gather``: the exchange that
    turns every rank's owned rows [y1 - y0, ...] into the whole [H, ...]
    tensor, in row order, on every rank."""

    y0: int
    y1: int
    gather: Callable[[torch.Tensor], torch.Tensor]


class RowWindow:
    """The compute rows of a rank: its owned rows [y0, y1) with ``halo``
    rows on each side, cyclic in the image's H rows."""

    def __init__(self, H: int, rows: Rows, halo: int = 0):
        if not 0 <= rows.y0 < rows.y1 <= H:
            raise ValueError(f"rows [{rows.y0}, {rows.y1}) outside an image "
                             f"of {H} rows")
        self.H, self.y0, self.y1 = H, rows.y0, rows.y1
        self._gather = rows.gather
        h = rows.y1 - rows.y0
        if halo <= 0:
            self.c0, self.hc = rows.y0, h
        elif h + 2 * halo < H:
            self.c0, self.hc = rows.y0 - halo, h + 2 * halo
        else:
            self.c0, self.hc = 0, H

    @classmethod
    def whole(cls, H: int) -> "RowWindow":
        """The untiled pass's window: every row, no exchange."""
        return cls(H, Rows(0, H, lambda t: t))

    @property
    def is_whole(self) -> bool:
        """This rank owns every row (the untiled pass)."""
        return self.y0 == 0 and self.y1 == self.H

    @property
    def cyclic(self) -> bool:
        """The compute rows run past the image's first or last row."""
        return self.c0 < 0 or self.c0 + self.hc > self.H

    def row_ids(self, device) -> torch.Tensor:
        """The image row of each compute row [hc] (int64)."""
        return torch.remainder(torch.arange(self.c0, self.c0 + self.hc,
                                            device=device), self.H)

    def take(self, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The compute rows of a whole tensor (rows on ``axis``)."""
        if not self.cyclic:
            return a.narrow(axis, self.c0, self.hc)
        return a.index_select(axis, self.row_ids(a.device))

    def own(self, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The owned rows of a tensor on the compute rows."""
        return a.narrow(axis, self.y0 - self.c0, self.y1 - self.y0)

    def commit(self, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The whole tensor from a tensor on the compute rows (rows on
        ``axis``): the owned rows of every rank, exchanged."""
        own = torch.movedim(self.own(a, axis), axis, 0).contiguous()
        return torch.movedim(self._gather(own), 0, axis)
