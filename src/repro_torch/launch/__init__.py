"""Launchers on PyTorch: the always-on fleet service
(:mod:`repro_torch.launch.serve`)."""
