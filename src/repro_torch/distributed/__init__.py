"""Distribution on ``torch.distributed``: the logical-axis sharding rules
and the mesh's process-group helpers (:mod:`repro_torch.distributed.
sharding`)."""

from repro_torch.distributed import sharding  # noqa: F401
