"""Sensing on PyTorch: ADC simulation (:mod:`repro_torch.sensing.adc`),
balanced fragment sampling (:mod:`repro_torch.sensing.fragments`), the
batched streaming runtime (:mod:`repro_torch.sensing.stream`), the
multi-sensor fleet with its energy report
(:mod:`repro_torch.sensing.fleet`), synthetic radar-like data
(:mod:`repro_torch.sensing.synthetic`) and Table I's baseline detectors
(:mod:`repro_torch.sensing.baselines`)."""
