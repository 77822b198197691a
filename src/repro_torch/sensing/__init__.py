"""Sensing on PyTorch: ADC simulation (:mod:`repro_torch.sensing.adc`),
balanced fragment sampling (:mod:`repro_torch.sensing.fragments`) and the
batched streaming runtime (:mod:`repro_torch.sensing.stream`)."""
