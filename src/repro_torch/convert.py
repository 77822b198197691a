"""Carry a HyperSense model's weights across into the port.

The tests build a model in the JAX package and hand its arrays over as
numpy (``np.asarray(jax_model.class_hvs)`` etc.), so that both packages
compute with identical parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.encoding import NonLin
from repro_torch.core.hypersense import HyperSenseModel


def model_from_arrays(class_hvs, B0, b, *, h: int, w: int, stride: int,
                      t_score: float, t_detection: int,
                      nonlinearity: NonLin = "rff",
                      device: str | torch.device | None = None
                      ) -> HyperSenseModel:
    """A :class:`HyperSenseModel` from ``(2, D)`` class hypervectors, the
    ``(h, D)`` generators and the ``(D,)`` phase, as float32 on ``device``
    (``None`` -> CUDA, raising without it)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    B0 = t(B0)
    if B0.shape[0] != h:
        raise ValueError(f"B0 has {B0.shape[0]} generator rows, h={h}")
    return HyperSenseModel(class_hvs=t(class_hvs), B0=B0, b=t(b), h=h, w=w,
                           stride=stride, t_score=float(t_score),
                           t_detection=int(t_detection),
                           nonlinearity=nonlinearity)
