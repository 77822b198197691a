"""Hand-written Hopper kernels for HyperSense's scoring and training paths.

* :mod:`repro_torch.kernels.sliding_scores`     — float32 fused encode+score
  (``csrc/sliding_scores.cu``) and its plain PyTorch version
* :mod:`repro_torch.kernels.sliding_scores_int` — integer-code encode+score
  (``csrc/sliding_scores_int.cu``) and its plain PyTorch version
* :mod:`repro_torch.kernels.hdc_encode`         — fused fragment encode
  against a dense base (``csrc/hdc_encode.cu``)
* :mod:`repro_torch.kernels.hdc_encode_perm`    — fused fragment encode
  against the permutation base (``csrc/hdc_encode_perm.cu``)
* :mod:`repro_torch.kernels.similarity`         — cosine classifier
  (``csrc/similarity.cu``)
* :mod:`repro_torch.kernels.int_expanded`       — the int scorer's retired
  expanded-slab layout, the live int kernel's yardstick
  (``csrc/int_expanded.cu``)
* :mod:`repro_torch.kernels.ops`                — kernel dispatch
* :mod:`repro_torch.kernels.ref`                — plain oracles
* :mod:`repro_torch.kernels._build`             — nvcc build + ctypes loader
"""
