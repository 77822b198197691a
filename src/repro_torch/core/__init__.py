"""HyperSense core on PyTorch: HDC ops, encoders, the fragment and frame
models, the online classifier update, the sensor-control state machines,
the detection metrics and the energy account.

* :mod:`repro_torch.core.hdc`            — bundle / bind / permute / similarity
* :mod:`repro_torch.core.encoding`       — RFF + permutation-structured encoders
* :mod:`repro_torch.core.fragment_model` — HDC fragment classifier
  (train / retrain)
* :mod:`repro_torch.core.hypersense`     — frame-level detector
* :mod:`repro_torch.core.online`         — streaming perceptron updates
* :mod:`repro_torch.core.sensor_control` — the intelligent-sensor-control gate
* :mod:`repro_torch.core.metrics`        — ROC / AUC / partial AUC / F1
* :mod:`repro_torch.core.energy`         — the end-to-end energy account
  (paper §V-E, Table III)
"""
