"""Launchers on PyTorch: the always-on fleet service
(:mod:`repro_torch.launch.serve`), the detector, train, prefill and
decode cells (:mod:`repro_torch.launch.steps`), the gated cascade that
feeds it the service's high-precision frames
(:mod:`repro_torch.launch.cascade`), greedy decoding
(:mod:`repro_torch.launch.decode`), the train launcher
(:mod:`repro_torch.launch.train`), the dry run
(:mod:`repro_torch.launch.dryrun`) and the host's device mesh
(:mod:`repro_torch.launch.mesh`)."""
