"""Architecture registry of the port: arch id -> exact published config.

Each module defines ``config()`` (the exact numbers) and ``smoke()`` (a
reduced config of the same family for CPU tests), as in
``repro.configs``. The port has the architectures its ported models run;
the others come with the LM zoo (``ROADMAP.md`` §1 item 7).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: F401

ARCH_IDS = ["hubert-xlarge"]

#: the paper's own workload (``configs/hypersense.py``: a
#: ``HyperSenseConfig``, not a ``ModelConfig``)
PAPER_CONFIG_ID = "hypersense"


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"{arch_id!r} is not ported yet (the port has "
                         f"{ARCH_IDS}); the other architectures come with "
                         f"the LM zoo, ROADMAP.md §1 item 7")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
