"""Distribution on ``torch.distributed``: the logical-axis sharding rules
and the mesh's process-group helpers (:mod:`repro_torch.distributed.
sharding`), and the roofline terms of a step on the H100
(:mod:`repro_torch.distributed.roofline`, imported on its own)."""

from repro_torch.distributed import sharding  # noqa: F401
