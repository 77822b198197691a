"""The paper's own workload config (HyperSense sensing, §V), as plain data.

The port's copy of ``repro.configs.hypersense``. Defaults match the FPGA
evaluation point: fragment 96x96, hypervector dimensionality 5K, 8-bit data
path, CRUW-geometry 128x128 frames.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HyperSenseConfig:
    frame_h: int = 128
    frame_w: int = 128
    fragment: int = 96          # paper Table II operating point
    stride: int = 8
    dim: int = 5000             # hypervector dimensionality (5K)
    adc_low_bits: int = 4
    adc_high_bits: int = 12
    t_score: float = 0.0
    t_detection: int = 0
    retrain_epochs: int = 20
    base_kind: str = "perm"     # permutation-structured (accelerator path)
    nonlinearity: str = "rff"


def config() -> HyperSenseConfig:
    return HyperSenseConfig()


def smoke() -> HyperSenseConfig:
    return HyperSenseConfig(frame_h=32, frame_w=32, fragment=8, stride=4,
                            dim=256, retrain_epochs=3)
