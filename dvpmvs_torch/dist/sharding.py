"""View-parallel execution of PatchMatch passes (counterpart of
``dvpmvs/dist/sharding.py``).

Phase-A distribution: each ``Problem`` (reference view) is independent
within a pass, so a batch of problems splits over the ranks of the ``views``
group; between geometric passes the per-view depth maps are exchanged (each
problem reads its source views' depths, the reference's cross-view
synchronization point, APD.cpp:1147-1166).

All problems in a batch share (H, W, V): the scene runner pads source counts
and image extents per round, and pads the batch to a multiple of the rank
count by repeating problems.  Rank r owns the contiguous slice
``[r B/n, (r+1) B/n)``, JAX's ``P("views")``.

Collectives take the process group explicitly (None: this process alone,
no collective).  They use the list form of ``all_gather``, which every
torch version has; with NCCL they exchange the tensors on the card, with
any other backend host copies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..config import PMStatic
from ..engine.patchmatch import run_pass
from ..engine.state import PassOutput


def shard_bounds(n_items: int, rank: int, size: int) -> tuple:
    """[lo, hi) of rank ``rank``'s contiguous slice of ``n_items`` (a
    multiple of ``size``)."""
    if n_items % size:
        raise ValueError(f"{n_items} problems do not split over {size} "
                         f"ranks")
    per = n_items // size
    return rank * per, (rank + 1) * per


def shard_problems(items, rank: int, size: int):
    """This rank's contiguous slice of a problem-batched sequence or tensor
    (leading axis = problems)."""
    lo, hi = shard_bounds(len(items), rank, size)
    return items[lo:hi]


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's ``t`` (same shape on each) along axis 0, in
    rank order, on ``t``'s device.  With no group, ``t`` itself.  NCCL
    exchanges copies on this rank's current card, any other backend host
    copies."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    on_card = dist.get_backend(group) == "nccl"
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = (src.to(torch.device("cuda", torch.cuda.current_device()))
           if on_card else src.cpu()).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts).to(t.device)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def exchange_src_depths(depths: torch.Tensor, src_index,
                        group=None) -> torch.Tensor:
    """Cross-view depth exchange for geometric passes.

    depths    [B_local, H, W]  this rank's problems' depth maps
    src_index [B_local, V]     for each local problem, the (global) PROBLEM
                               indices of its sources
    returns   [B_local, V, H, W] source depth stacks.

    Every rank's maps are all-gathered (each rank reads every other rank's
    depth maps once per pass), then indexed: JAX's ``jnp.take`` over the
    view-sharded batch, whose all-gather XLA inserts.
    """
    full = all_gather(depths, group)
    idx = torch.as_tensor(src_index, dtype=torch.int64, device=full.device)
    return full[idx]


def make_batched_pass(static: PMStatic, device):
    """``run_pass`` over a leading axis of local problems, one problem at a
    time in order: JAX's ``lax.map`` inside ``shard_map``.  No vmap here
    either: each problem runs the single-view pass with its own kernels.

    The returned ``batched(ref_imgs, src_imgs, ref_cams, src_cams, dyns,
    draws, **optional)`` takes sequences (tensors or lists) with a leading
    axis of B_local problems:
      ref_imgs [B, H, W], src_imgs [B, V, H, W], ref_cams [B] Cameras,
      src_cams [B] stacked Cameras, dyns [B] PMDynamic, draws [B] draw
      sources; optional: init_plane_world [B, H, W, 4], init_sel
      [B, H, W, V], init_weak [B, H, W], src_depths [B, V, H, W],
      radius_map [B, H, W], edge [B, H, W], label [B, H, W]
    and returns a PassOutput whose fields carry the leading [B].
    """

    def batched(ref_imgs, src_imgs, ref_cams, src_cams, dyns, draws,
                init_plane_world=None, init_sel=None, init_weak=None,
                src_depths=None, radius_map=None, edge=None,
                label=None) -> PassOutput:
        at = lambda a, i: None if a is None else a[i]
        outs = [run_pass(ref_imgs[i], src_imgs[i], ref_cams[i], src_cams[i],
                         static=static, dyn=dyns[i], draws=draws[i],
                         init_plane_world=at(init_plane_world, i),
                         init_sel_views=at(init_sel, i),
                         init_weak=at(init_weak, i),
                         src_depths=at(src_depths, i),
                         radius_map=at(radius_map, i), edge=at(edge, i),
                         label=at(label, i), device=device)
                for i in range(len(draws))]
        return stack_outputs(outs)

    return batched


def stack_outputs(outs: Sequence[PassOutput]) -> PassOutput:
    """PassOutputs of single problems as one with a leading problem axis
    (a field that is None in the first is None in the result)."""
    fields = {}
    for f in dataclasses.fields(PassOutput):
        vals = [getattr(o, f.name) for o in outs]
        fields[f.name] = (None if vals[0] is None
                          else torch.stack([torch.as_tensor(v) for v in vals]))
    return PassOutput(**fields)


def group_rank(group: Optional[object]) -> int:
    """This process's rank in ``group`` (0 with no group)."""
    return 0 if group is None else dist.get_rank(group)


def group_size(group: Optional[object]) -> int:
    """The number of ranks of ``group`` (1 with no group)."""
    return 1 if group is None else dist.get_world_size(group)


def local_slice(group: Optional[object], n_items: int) -> tuple:
    """[lo, hi) of this process's slice of ``n_items`` problems in
    ``group`` (everything with no group)."""
    return shard_bounds(n_items, group_rank(group), group_size(group))
