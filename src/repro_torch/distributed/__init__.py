"""Distribution on ``torch.distributed``: the logical-axis sharding rules
and the mesh's process-group helpers (:mod:`repro_torch.distributed.
sharding`), the roofline terms of a step on the H100
(:mod:`repro_torch.distributed.roofline`) and the analytic memory model
of a cell (:mod:`repro_torch.distributed.memory_model`), the last two
imported on their own."""

from repro_torch.distributed import sharding  # noqa: F401
