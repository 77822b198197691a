"""Model substrate on PyTorch: parameter specs and their sharding, norms
and RoPE (:mod:`repro_torch.models.common`), attention
(:mod:`repro_torch.models.attention`), the dense MLP
(:mod:`repro_torch.models.mlp`) and the transformer facade
(:mod:`repro_torch.models.lm`, with its loss), for the encoder family the
gated cascade's detector runs, on one device or sharded over a mesh."""
