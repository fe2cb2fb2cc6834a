"""Multi-device runs on ``torch.distributed`` (counterpart of
``dvpmvs/dist``): the ``views`` group and its launcher (mesh.py), the
view-sharded batched pass and the depth exchange (sharding.py), the
row-tiled pass of one view and the (views, tile) layout (tiles.py), and the
multi-host runner (multihost.py)."""

from .mesh import ViewMesh, backend_for, init_group, launch, make_mesh
from .sharding import (all_gather, exchange_src_depths, make_batched_pass,
                       run_views_sharded, shard_problems)
from .tiles import (Mesh2, make_mesh2, make_tiled_pass, mesh2_layout,
                    row_bounds)

__all__ = ["ViewMesh", "backend_for", "init_group", "launch", "make_mesh",
           "all_gather", "exchange_src_depths", "make_batched_pass",
           "run_views_sharded", "shard_problems", "Mesh2",
           "make_mesh2", "make_tiled_pass", "mesh2_layout", "row_bounds"]
