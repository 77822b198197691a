"""Sensing on PyTorch: ADC simulation (:mod:`repro_torch.sensing.adc`) and
the batched streaming runtime (:mod:`repro_torch.sensing.stream`)."""
