"""Phase-B distribution: the row-tiled pass of one large view over the ranks
of a ``tile`` group (counterpart of ``dvpmvs/dist/tiles.py``).

When a single image is too large for one device, its rows split over the
ranks: rank r of n computes rows [r H/n, (r+1) H/n), JAX's ``P("tile",
None)``.  JAX writes no halo code: XLA's SPMD partitioner inserts every halo
exchange and all-gather.  PyTorch has no partitioner, and several reads of
the pass reach beyond any fixed halo (the edge candidates' per-pixel
offsets, the anchor rays, K3's reprojections into whole source depths, K4's
gathers at anchor coordinates, the weak compaction's global rank).  So here
every rank keeps the whole pass state; ``run_pass`` (``rows``) computes the
heavy per-pixel stages on the rank's rows against whole tensors at absolute
coordinates, and each stage that commits ends with an all-gather of the
owned rows (``sharding.all_gather``).  The partition then changes no draw
and no rank order, and every rank returns the whole ``PassOutput``, equal
to the untiled pass bit for bit.  That trades the transients of the windowed
stages, which fall as 1/n, against ~75 B a pixel of state kept whole.

The two axes compose as a (views, tile) layout of the world's ranks
(``make_mesh2``): problems split over ``views``, rows over ``tile``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch.distributed as dist

from .. import resolve_device
from ..config import PMStatic
from ..engine.patchmatch import run_pass
from ..engine.rows import Rows
from ..engine.state import PassOutput
from .mesh import ViewMesh
from .sharding import all_gather


def row_bounds(H: int, rank: int, size: int) -> Tuple[int, int]:
    """[y0, y1) of rank ``rank``'s rows of an H-row image over ``size``
    ranks; H must divide (JAX's tiled pass refuses the same)."""
    if H % size:
        raise ValueError(f"H={H} not divisible by tile axis {size}")
    per = H // size
    return rank * per, (rank + 1) * per


def mesh2_layout(world: int, n_views: int, n_tiles: int
                 ) -> Tuple[List[List[int]], List[List[int]]]:
    """The (views, tile) layout of the first n_views x n_tiles of ``world``
    ranks, rank = v * n_tiles + t (JAX's ``devs[:need].reshape(n_views,
    n_tiles)``): (the ``views`` groups, one per tile index t, and the
    ``tile`` groups, one per view index v), each a list of ranks."""
    need = n_views * n_tiles
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    views = [[v * n_tiles + t for v in range(n_views)]
             for t in range(n_tiles)]
    tiles = [[v * n_tiles + t for t in range(n_tiles)]
             for v in range(n_views)]
    return views, tiles


@dataclasses.dataclass(frozen=True)
class Mesh2:
    """One rank's place in the (views, tile) layout; both None for a rank
    past n_views x n_tiles."""

    views: Optional[ViewMesh]
    tile: Optional[ViewMesh]


def make_mesh2(n_views: int, n_tiles: int, group=None, device=None) -> Mesh2:
    """Split the ranks of ``group`` (the world by default) into ``views``
    and ``tile`` subgroups (``dist.new_group``; every rank of ``group``
    must call this with the same arguments).  Raises ``ValueError`` when
    the group has fewer than n_views x n_tiles ranks."""
    dev = resolve_device(device)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    views, tiles = mesh2_layout(world, n_views, n_tiles)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(world)))
    g_views = [dist.new_group([ranks[r] for r in rs]) for rs in views]
    g_tiles = [dist.new_group([ranks[r] for r in rs]) for rs in tiles]
    if rank >= n_views * n_tiles:
        return Mesh2(None, None)
    v, t = divmod(rank, n_tiles)
    return Mesh2(views=ViewMesh(g_views[t], v, n_views, dev),
                 tile=ViewMesh(g_tiles[v], t, n_tiles, dev))


def make_tiled_pass(static: PMStatic, mesh: ViewMesh):
    """``run_pass`` with its rows split over ``mesh``, the ``tile`` axis
    (``dist.make_mesh`` of the group, or ``make_mesh2``'s ``tile``).

    Returns fn(ref_img, src_imgs, ref_cam, src_cams, dyn, draws, **optional)
    -> the whole PassOutput, the same on every rank of the mesh and equal
    to the untiled pass on the same inputs and draws.  Every rank gets the
    whole inputs.  H must be divisible by the mesh size (``ValueError``);
    with no group, or a group of one, it is ``run_pass`` itself."""

    def call(ref_img, src_imgs, ref_cam, src_cams, dyn, draws,
             **kw) -> PassOutput:
        rows = None
        if mesh.group is not None and mesh.size > 1:
            y0, y1 = row_bounds(int(ref_img.shape[0]), mesh.rank, mesh.size)
            rows = Rows(y0, y1, lambda t: all_gather(t, mesh.group))
        return run_pass(ref_img, src_imgs, ref_cam, src_cams, static=static,
                        dyn=dyn, draws=draws, device=mesh.device, rows=rows,
                        **kw)

    return call
