"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936,
MoE 128e top-8, head_dim=128, QK-norm (Qwen3 family).
A copy of ``repro.configs.qwen3_moe_235b_a22b``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, kv_heads=4,
        head_dim=128, d_ff=1536, vocab=151936,
        n_experts=128, top_k=8, qk_norm=True,
        rope_theta=1e6,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=64, vocab=512, n_experts=8, top_k=2,
        compute_dtype="float32", remat="none")
