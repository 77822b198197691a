"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (blocks carry internal expansions only)
vocab=50304. Every 8th block is sLSTM (xLSTM[7:1]-style ratio), the rest
mLSTM; sub-quadratic -> runs the long_500k shape. A copy of
``repro.configs.xlstm_350m``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, kv_heads=4,
        d_ff=0, vocab=50304,
        slstm_every=8,
        scan_layers=False,   # heterogeneous block mix
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=2, vocab=512, slstm_every=3,
        ssm_chunk=16, compute_dtype="float32", remat="none")
