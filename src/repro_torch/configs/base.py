"""Config dataclasses (model architecture, input shape) and the assigned
shape cells (``SHAPES``, ``applicable_shapes``).

A copy of ``repro.configs.base`` kept inside the port, so that
``repro_torch`` imports nothing of the JAX package. One ``ModelConfig`` per
architecture lives in ``repro_torch.configs.<arch_id>`` with the exact
published numbers, beside a ``smoke()`` config of the same family reduced
for CPU tests.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Literal["dense", "moe", "hybrid", "ssm", "encoder", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    norm: str = "rmsnorm"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    is_encoder: bool = False
    activation: str = "silu"
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_int8: bool = False
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    shared_attn_every: int = 0        # zamba2: shared block cadence
    slstm_every: int = 0              # xlstm: every k-th block is sLSTM
    ssm_chunk: int = 256
    # --- VLM ---
    n_image_tokens: int = 0
    # --- embeds-in stub (audio/vlm frontends per assignment) ---
    embeds_in: bool = False           # inputs are embeddings, not token ids
    # --- execution ---
    scan_layers: bool = True
    remat: str = "full"               # full | dots | none
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The assigned shape set (identical for every LM arch).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: smoke-test shape (reduced)
SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")


def applicable_shapes(cfg: ModelConfig) -> dict[str, ShapeConfig | None]:
    """Which of the 4 assigned shapes run for this arch (None = skip).

    Skip rules: encoder-only archs have no decode step; long_500k runs
    only for sub-quadratic (ssm/hybrid) archs.
    """
    out: dict[str, ShapeConfig | None] = dict(SHAPES)
    if cfg.is_encoder:
        out["decode_32k"] = None
        out["long_500k"] = None
    if cfg.family not in ("ssm", "hybrid"):
        out["long_500k"] = None
    return out


SKIP_REASONS = {
    ("encoder", "decode_32k"): "encoder-only arch: no decode step exists",
    ("encoder", "long_500k"): "encoder-only arch: no decode step exists",
    ("full_attn", "long_500k"):
        "pure full-attention arch: 500K context requires sub-quadratic "
        "attention (assignment: run only for SSM/hybrid/linear-attn)",
}
