"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 (per expert) vocab=131072.
A copy of ``repro.configs.grok_1_314b``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, kv_heads=8,
        d_ff=32768, vocab=131072,
        n_experts=8, top_k=2,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=96, n_heads=6, kv_heads=2, d_ff=128,
        vocab=512, n_experts=4, top_k=2,
        compute_dtype="float32", remat="none")
