"""HyperSense core on PyTorch: HDC ops, encoders, the frame model, the
online classifier update and the sensor-control state machines.

* :mod:`repro_torch.core.hdc`            — bundle / bind / permute / similarity
* :mod:`repro_torch.core.encoding`       — RFF + permutation-structured encoders
* :mod:`repro_torch.core.hypersense`     — frame-level detector
* :mod:`repro_torch.core.online`         — streaming perceptron updates
* :mod:`repro_torch.core.sensor_control` — the intelligent-sensor-control gate
"""
