"""zamba2-1.2b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
The shared transformer block (one parameter copy) runs every 6 Mamba
layers with an embedding re-injection (additive-projected, as in the
reference). A copy of ``repro.configs.zamba2_1_2b``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, kv_heads=32,
        d_ff=8192, vocab=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2,
        shared_attn_every=6,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        vocab=512, ssm_state=8, ssm_head_dim=16, shared_attn_every=2,
        ssm_chunk=16, compute_dtype="float32", remat="none")
