"""Sensing on PyTorch: ADC simulation (:mod:`repro_torch.sensing.adc`),
balanced fragment sampling (:mod:`repro_torch.sensing.fragments`), the
batched streaming runtime (:mod:`repro_torch.sensing.stream`) and the
multi-sensor fleet with its energy report
(:mod:`repro_torch.sensing.fleet`)."""
