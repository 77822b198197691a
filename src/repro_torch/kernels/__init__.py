"""Hand-written Hopper kernels for HyperSense's scoring hot path.

* :mod:`repro_torch.kernels.sliding_scores`     — float32 fused encode+score
  (``csrc/sliding_scores.cu``) and its plain PyTorch version
* :mod:`repro_torch.kernels.sliding_scores_int` — integer-code encode+score
  (``csrc/sliding_scores_int.cu``) and its plain PyTorch version
* :mod:`repro_torch.kernels.ops`                — scorer dispatch
* :mod:`repro_torch.kernels.ref`                — plain oracles
* :mod:`repro_torch.kernels._build`             — nvcc build + ctypes loader
"""
