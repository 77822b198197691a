"""Device meshes over ``torch.distributed``. Twin of
``repro.launch.mesh``: the ``("data", "model")`` mesh of the host's ranks
that the sharded fleet, its service, the sharded cascade and the sharded
cells run on, and the production meshes the dry run
(:mod:`repro_torch.launch.dryrun`) counts a rank of.

FUNCTIONS, not module-level constants: importing this module touches no
process group.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The reference's production mesh over the default process group: a
    16x16 ``("data", "model")`` mesh of 256 ranks, or with ``multi_pod``
    a 2x16x16 ``("pod", "data", "model")`` mesh of 512. The group must
    hold exactly that many ranks (the dry run's is a fake one, every rank
    of it counted in one process)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a process "
                         f"group of {math.prod(shape)} ranks, not {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A ``(1, world)`` ``("data", "model")`` mesh over the ranks of the
    default process group, which must be initialized: one card per rank
    with ``"cuda"`` (each rank calls ``torch.cuda.set_device`` first), or
    one process per rank with ``"cpu"`` (``gloo``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs torch.distributed's default "
                           "process group (init_process_group)")
    return init_device_mesh(device_type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
