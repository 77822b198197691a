"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447; unverified].

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (masked-unit targets).
A copy of ``repro.configs.hubert_xlarge``. The conv waveform frontend is a
stub: the inputs are precomputed frame embeddings (b, s, d_model); the
transformer backbone and the unit-prediction head are real. No decode step
(encoder-only).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="hubert-xlarge", family="encoder",
        n_layers=48, d_model=1280, n_heads=16, kv_heads=16,
        d_ff=5120, vocab=504,
        is_encoder=True, causal=False, embeds_in=True,
        norm="layernorm", activation="gelu",
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        vocab=64, compute_dtype="float32", remat="none")
