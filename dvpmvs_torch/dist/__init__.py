"""Multi-device runs on ``torch.distributed`` (counterpart of
``dvpmvs/dist``): the ``views`` group and its launcher (mesh.py), the
view-sharded batched pass and the depth exchange (sharding.py), and the
multi-host runner (multihost.py).  The row-tiled pass of ``dvpmvs/dist/
tiles.py`` is not ported (ROADMAP.md, Queue 1 item 7)."""

from .mesh import ViewMesh, backend_for, init_group, launch, make_mesh
from .sharding import (all_gather, exchange_src_depths, make_batched_pass,
                       shard_problems)

__all__ = ["ViewMesh", "backend_for", "init_group", "launch", "make_mesh",
           "all_gather", "exchange_src_depths", "make_batched_pass",
           "shard_problems"]
