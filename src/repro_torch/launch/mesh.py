"""The ``(pod, data)`` mesh of the Pig collective schedules on
``torch.distributed``: the counterpart of ``repro.launch.mesh`` and of the
named axes that ``shard_map`` gives ``repro.collectives.schedules``.

A world of ``npods * G`` ranks, rank r = pod * G + d.  Process groups
stand in for the axis names: ``Mesh.group`` is this rank's pod (the
``data`` axis, group rank = d), ``Mesh.pod`` its cross-pod group (the
``pod`` axis, group rank = pod) and ``Mesh.world`` both axes at once.  The
reference's ``model`` axis is replicated in the schedules and drops out;
tensor-parallel axes belong to the sharding layer, not here.

The sharding layer's production mesh (``make_production_mesh``) is a
named ``DeviceMesh`` over whatever world is initialised: a FUNCTION, not a
module constant, so importing this module touches no device or process
group state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    npods: int
    G: int
    group: dist.ProcessGroup     # in-pod: ranks pod*G .. pod*G + G - 1
    pod: dist.ProcessGroup       # cross-pod: ranks d, G + d, 2G + d, ...
    world: dist.ProcessGroup     # every rank: the ('pod', 'data') axes


def init(rank: int, world: int, store: dist.Store,
         device=None) -> torch.device:
    """Join a world of ``world`` ranks through ``store`` (a ``FileStore`` or
    ``TCPStore``; nothing here reads a cluster's environment).  NCCL on the
    CUDA device (rank r on card r modulo the cards), the default; gloo only
    when the caller passes ``device="cpu"``.  There is no fallback from
    NCCL to gloo.  Returns this rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world)
    return dev


def make_mesh(npods: int, group_size: int,
              backend: Optional[str] = None) -> Mesh:
    """This rank's view of an ``npods x group_size`` mesh over the initialised
    world.  Every rank creates every subgroup in the same order, as
    ``new_group`` requires.  ``backend`` (e.g. ``"gloo"`` for a CPU mesh
    inside an NCCL world) defaults to the world's."""
    world = dist.get_world_size()
    if world != npods * group_size:
        raise ValueError(f"make_mesh: {npods} pods x {group_size} ranks != "
                         f"a world of {world}")
    p, d = divmod(dist.get_rank(), group_size)
    kw = {} if backend is None else {"backend": backend}
    everyone = dist.new_group(list(range(world)), **kw)
    groups = [dist.new_group([q * group_size + e for e in range(group_size)],
                             **kw) for q in range(npods)]
    pods = [dist.new_group([q * group_size + e for q in range(npods)], **kw)
            for e in range(group_size)]
    return Mesh(npods=npods, G=group_size, group=groups[p], pod=pods[d],
                world=everyone)


def mesh_axes(multi_pod: bool) -> tuple:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def chips(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def make_production_mesh(multi_pod: bool = False):
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2x16x16 =
    512 ranks (pod, data, model).  A ``DeviceMesh`` over the initialised
    world, whose size must be ``chips(multi_pod)``.  Its device type is
    the CPU: the dry-run, its one caller, traces on the meta device over a
    fake world in one process (``launch.dryrun``)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = chips(multi_pod)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs a world of {n} ranks, not "
                         f"{dist.get_world_size()}")
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=mesh_axes(multi_pod))
