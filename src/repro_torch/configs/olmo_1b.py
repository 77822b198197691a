"""olmo-1b — dense, non-parametric LayerNorm [arXiv:2402.00838; hf].

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
A copy of ``repro.configs.olmo_1b``. Its norms hold no parameters
(``norm_spec(d, "nonparametric_ln") == {}``).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, kv_heads=16,
        d_ff=8192, vocab=50304,
        norm="nonparametric_ln",
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        vocab=512, compute_dtype="float32", remat="none")
