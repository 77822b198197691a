"""Device meshes over ``torch.distributed``. Twin of the host half of
``repro.launch.mesh``: the ``("data", "model")`` mesh of the host's ranks
that the sharded fleet, its service and the sharded cascade run on.

A FUNCTION, not a module-level constant: importing this module touches no
process group. ``make_production_mesh`` (the reference's 256-chip TPU
mesh) waits for the dry-run slice (``launch/dryrun.py`` with
``distributed/memory_model.py``).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


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
