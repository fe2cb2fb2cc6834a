"""The port's stand-in for a device mesh (counterpart of
``dvpmvs/dist/mesh.py``).

JAX sees N devices from one process and lays them out as a ``views`` mesh;
``shard_map`` then runs each device's problems.  Here each device is driven
by its own process and the processes are joined by ``torch.distributed``:
rank r runs on its own device, with NCCL between cards and gloo on the CPU
(or between ranks that share one card, which NCCL refuses).  One process
driving several cards would serialise the host's launch stream, which bounds
the passes.

A ``ViewMesh`` is what a rank knows of the mesh: the process group (None for
one process), its rank and size along ``views``, and its device.  Every
collective takes the group explicitly.  ``launch`` starts n ranks with
``torch.multiprocessing`` (spawn, never fork) and a rendezvous through a
file, so no TCP port is fixed; nothing switches backend by itself, so a
failed ``init_process_group`` raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class ViewMesh:
    """One rank's view of the ``views`` axis."""

    group: Optional[object]      # torch.distributed ProcessGroup, or None
    rank: int
    size: int
    device: torch.device


def backend_for(device) -> str:
    """The default backend of a device: NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(group=None, device=None) -> ViewMesh:
    """The mesh of ``group`` (None: this process alone) on ``device`` (the
    card unless the caller asks for another)."""
    dev = resolve_device(device)
    if group is None:
        return ViewMesh(None, 0, 1, dev)
    return ViewMesh(group, dist.get_rank(group), dist.get_world_size(group),
                    dev)


def init_group(rank: int, world_size: int, rendezvous, backend: str,
               device, timeout_s: float = 600.0):
    """Join the group of ``world_size`` ranks that meet at the file
    ``rendezvous`` (absent before the first rank arrives) and return it.
    A card is made this rank's current device first, as NCCL needs."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=Path(rendezvous).absolute().as_uri(),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def _rank_main(rank, fn, nprocs, rendezvous, backend, devices, args,
               results, threads, timeout_s):
    if threads:
        torch.set_num_threads(threads)
    group = init_group(rank, nprocs, rendezvous, backend, devices[rank],
                       timeout_s)
    try:
        out = fn(make_mesh(group, devices[rank]), *args)
        with open(Path(results) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: Sequence = (), *, workdir,
           devices: Optional[Sequence] = None, backend: Optional[str] = None,
           threads: Optional[int] = None, timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` new ranks and return their
    results in rank order.

    ``fn`` must be importable (a module-level function) and its result
    picklable.  ``devices`` gives each rank's device (default: rank r on
    card r); ``backend`` defaults to that of the first device.  The
    rendezvous file and the results go to ``workdir``.  ``threads`` caps
    each rank's torch threads.  A rank that raises ends the others and the
    error is raised here.
    """
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in (
        devices if devices is not None
        else [f"cuda:{r}" for r in range(nprocs)])]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    backend = backend or backend_for(devices[0])
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    rendezvous = work / "rendezvous"
    if rendezvous.exists():
        rendezvous.unlink()
    for r in range(nprocs):
        (work / f"rank{r}.pkl").unlink(missing_ok=True)
    mp.start_processes(
        _rank_main, args=(fn, nprocs, str(rendezvous), backend, devices,
                          tuple(args), str(work), threads, timeout_s),
        nprocs=nprocs, join=True, start_method="spawn")
    out = []
    for r in range(nprocs):
        with open(work / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out

