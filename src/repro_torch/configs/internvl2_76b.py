"""internvl2-76b — InternViT + InternLM2 VLM [arXiv:2404.16821; unverified].

Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256, 256
image tokens prepended to the text sequence. A copy of
``repro.configs.internvl2_76b``. The vision frontend is a stub: the image
prefix comes in as precomputed ``(b, n_image_tokens, d_model)`` patch
embeddings.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, kv_heads=8,
        d_ff=28672, vocab=128256,
        n_image_tokens=256,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=512, n_image_tokens=8,
        compute_dtype="float32", remat="none")
