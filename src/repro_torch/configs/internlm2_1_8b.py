"""internlm2-1.8b — dense GQA [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
A copy of ``repro.configs.internlm2_1_8b``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, kv_heads=8,
        d_ff=8192, vocab=92544,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=512, compute_dtype="float32", remat="none")
