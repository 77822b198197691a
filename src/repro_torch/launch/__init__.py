"""Launchers on PyTorch: the always-on fleet service
(:mod:`repro_torch.launch.serve`), the detector, train and prefill cells
(:mod:`repro_torch.launch.steps`), the gated cascade that feeds it the
service's high-precision frames (:mod:`repro_torch.launch.cascade`) and
the host's device mesh (:mod:`repro_torch.launch.mesh`)."""
