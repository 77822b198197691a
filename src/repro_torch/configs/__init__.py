"""Architecture registry of the port: arch id -> exact published config.

Each module defines ``config()`` (the exact numbers) and ``smoke()`` (a
reduced config of the same family for CPU tests), as in
``repro.configs``, with the same architectures in the reference's order:
the hybrid (Mamba-2 with a shared attention block), the mixture of
experts, the encoder, the dense, ssm (xLSTM) and vlm families.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, SKIP_REASONS,  # noqa: F401
                                      SMOKE_SHAPE, ModelConfig, ShapeConfig,
                                      applicable_shapes)

ARCH_IDS = [
    "zamba2-1.2b",
    "qwen3-moe-235b-a22b",
    "grok-1-314b",
    "hubert-xlarge",
    "olmo-1b",
    "codeqwen1.5-7b",
    "internlm2-1.8b",
    "deepseek-67b",
    "xlstm-350m",
    "internvl2-76b",
]

#: the paper's own workload (``configs/hypersense.py``: a
#: ``HyperSenseConfig``, not a ``ModelConfig``)
PAPER_CONFIG_ID = "hypersense"


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"no config {arch_id!r}; the architectures are "
                         f"{ARCH_IDS}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
