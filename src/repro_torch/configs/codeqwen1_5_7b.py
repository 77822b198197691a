"""codeqwen1.5-7b — dense qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf].

32L d_model=4096 32H (MHA kv=32) d_ff=13440 vocab=92416.
A copy of ``repro.configs.codeqwen1_5_7b``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, kv_heads=32,
        d_ff=13440, vocab=92416,
        rope_theta=1e6,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=192,
        vocab=512, compute_dtype="float32", remat="none")
