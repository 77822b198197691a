"""Launchers on PyTorch: the always-on fleet service
(:mod:`repro_torch.launch.serve`), the detector cell
(:mod:`repro_torch.launch.steps`) and the gated cascade that feeds it the
service's high-precision frames (:mod:`repro_torch.launch.cascade`)."""
