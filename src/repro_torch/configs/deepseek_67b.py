"""deepseek-67b — dense llama-arch [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
A copy of ``repro.configs.deepseek_67b``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-67b", family="dense",
        n_layers=95, d_model=8192, n_heads=64, kv_heads=8,
        d_ff=22016, vocab=102400,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, kv_heads=2, d_ff=192,
        vocab=512, compute_dtype="float32", remat="none")
