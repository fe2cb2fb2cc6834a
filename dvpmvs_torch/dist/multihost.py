"""Multi-host scene scheduling (counterpart of ``dvpmvs/dist/multihost.py``).

The reference is single-process/single-GPU (``cudaSetDevice``,
main.cpp:434; multi-GPU = run several processes by hand).  Here a scene
distributes over hosts as:

  * each process owns the problems with ``index % process_count ==
    process_index`` (views are independent within a pass);
  * between passes the per-view state syncs through the shared checkpoint
    directory (the reference's own file-based state model,
    main.cpp:365-376), behind a ``torch.distributed`` barrier, so geometric
    passes see every source view's previous-pass depth; or, with no shared
    directory, through an all-gather of the packed states.

Single-process (process_count == 1) degenerates to SceneRunner exactly,
which is how tests cover the partitioning logic.  Processes join a group
with :func:`init_distributed` (under ``torchrun``) or
:func:`dvpmvs_torch.dist.mesh.init_group`, and the group is given to the
runner explicitly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import PMStatic, SceneConfig
from ..io.dmb import read_bin_mat
from ..io.scene import format_index
from ..sched.runner import (PACK_CHANNELS, SceneRunner, ViewState,
                            pack_view, unpack_view)
from .mesh import backend_for
from .sharding import all_gather


def init_distributed(backend: Optional[str] = None, device=None):
    """Join the ``torchrun`` group (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) and return it;
    None outside ``torchrun``.  The backend is ``backend``, else that of
    ``device`` (NCCL for a card, the default; gloo for the CPU)."""
    import os

    if dist.is_initialized():
        return dist.group.WORLD
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(dev),
                            init_method="env://")
    return dist.group.WORLD


def host_problems(problems, process_index: Optional[int] = None,
                  process_count: Optional[int] = None, group=None):
    """The subset of problems this host owns (strided for load balance:
    pair.txt orders views by capture sequence, so neighboring problems have
    similar cost).  The index and count default to the group's rank and
    size (0 and 1 with no group)."""
    pi, pc = _index_count(process_index, process_count, group)
    return [p for i, p in enumerate(problems) if i % pc == pi]


def _index_count(process_index, process_count, group):
    pi = (process_index if process_index is not None
          else dist.get_rank(group) if group is not None else 0)
    pc = (process_count if process_count is not None
          else dist.get_world_size(group) if group is not None else 1)
    return pi, pc


class MultiHostRunner(SceneRunner):
    """SceneRunner that owns a host's problem slice and syncs state through
    the shared checkpoint directory between passes (or, with no directory,
    over the group's all-gather)."""

    def __init__(self, scene, config: Optional[SceneConfig] = None,
                 base_static: Optional[PMStatic] = None,
                 checkpoint_dir: Optional[Path] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None, group=None, **kw):
        super().__init__(scene, config, base_static, **kw)
        self._all_problems = list(scene.problems)
        self._pi, self._pc = _index_count(process_index, process_count,
                                          group)
        self._host_group = group
        self.scene.problems = host_problems(self._all_problems,
                                            self._pi, self._pc)
        self._sync_dir = Path(checkpoint_dir) if checkpoint_dir else None
        # foreign-view sync rewrites self.state between passes, so the
        # batched device-resident shortcut must re-read host state each pass
        self._sync_each_pass = True

    # SceneRunner.run() calls run_schedule_pass, then checkpoint(); we write
    # only owned views, barrier, pull foreign views.
    def checkpoint(self, out_root: Path, view_ids=None) -> None:
        if view_ids is None:
            view_ids = sorted(p.ref_image_id for p in self.scene.problems)
        super().checkpoint(out_root, view_ids)
        self._sync_foreign_views(out_root)

    def write_benchmark_outputs(self, out_root: Path, view_ids=None) -> None:
        """The final outputs of the views this host owns (every host holds
        the foreign views too, but two hosts never write one file)."""
        if view_ids is None:
            view_ids = sorted(p.ref_image_id for p in self.scene.problems)
        super().write_benchmark_outputs(out_root, view_ids)

    def _sync_foreign_views(self, out_root: Path) -> None:
        if self._pc == 1:
            return
        if self._host_group is not None:
            dist.barrier(group=self._host_group)
        # pull the source views owned by other hosts into self.state so the
        # next geometric pass reads current depths (APD.cpp:1147-1166)
        owned = {p.ref_image_id for p in self.scene.problems}
        needed = {s for p in self.scene.problems
                  for s in p.src_image_ids} - owned
        self._load_views(out_root, sorted(needed))

    def _load_views(self, out_root: Path, view_ids) -> None:
        for rid in view_ids:
            d = Path(out_root) / format_index(rid)
            if not (d / "depths.dmb").exists():
                continue
            bits = read_bin_mat(d / "selected_views.bin").astype(np.int32)
            V = max(1, int(bits.max()).bit_length())
            self.state[rid] = ViewState(
                depth=read_bin_mat(d / "depths.dmb").astype(np.float32),
                normal_world=read_bin_mat(
                    d / "APD_normals.dmb").astype(np.float32),
                weak=read_bin_mat(d / "weak.bin").astype(np.int8),
                sel_views=np.stack([(bits >> v) & 1 for v in range(V)],
                                   axis=-1).astype(bool),
                radius=read_bin_mat(d / "radius.bin").astype(np.float32))

    # ------------------------------------------------------------------
    # Collective state exchange, the filesystem-free alternative: each
    # host packs its owned views' post-pass state into one fixed-shape
    # array and the hosts all-gather it.
    def _pack_state(self):
        """Pack this host's owned post-pass view states into fixed-shape
        arrays (ids [max_owned], pack [max_owned, 8, H, W]) suitable for an
        all-gather.  Channels: depth, nx, ny, nz, weak, selbits, radius."""
        owned = sorted(p.ref_image_id for p in self.scene.problems
                       if p.ref_image_id in self.state)
        max_owned = -(-len(self._all_problems) // self._pc)
        H, W = self.state[owned[0]].depth.shape
        pack = np.zeros((max_owned, PACK_CHANNELS, H, W), np.float32)
        ids = np.full((max_owned,), -1, np.int32)
        for i, rid in enumerate(owned):
            ids[i] = rid
            pack[i] = pack_view(self.state[rid])
        return ids, pack

    def _unpack_foreign(self, all_ids, all_pack, num_views: int) -> None:
        """Install gathered foreign view states (inverse of _pack_state)."""
        owned = {p.ref_image_id for p in self.scene.problems}
        all_ids = np.asarray(all_ids).reshape(-1)
        H, W = np.asarray(all_pack).shape[-2:]
        all_pack = np.asarray(all_pack).reshape(-1, PACK_CHANNELS, H, W)
        for rid, pk in zip(all_ids, all_pack):
            if rid < 0 or int(rid) in owned:
                continue
            self.state[int(rid)] = unpack_view(pk, num_views)

    def exchange_state_collective(self) -> None:
        if self._pc == 1:
            return
        if self._host_group is None:
            raise ValueError("the collective exchange needs the hosts' "
                             "process group (group=...)")
        ids, pack = self._pack_state()
        owned = sorted(p.ref_image_id for p in self.scene.problems
                       if p.ref_image_id in self.state)
        V = self.state[owned[0]].sel_views.shape[-1]
        all_ids = all_gather(torch.from_numpy(ids), self._host_group)
        all_pack = all_gather(torch.from_numpy(pack), self._host_group)
        self._unpack_foreign(all_ids.numpy(), all_pack.numpy(), V)

    def run_schedule_pass(self, round_idx: int, pass_idx: int) -> None:
        super().run_schedule_pass(round_idx, pass_idx)
        if self._sync_dir is None:
            # no shared filesystem: exchange state over the interconnect
            self.exchange_state_collective()
