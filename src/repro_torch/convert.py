"""Carry a HyperSense or Fragment model's weights across into the port.

The tests build a model in the JAX package and hand its arrays over as
numpy (``np.asarray(jax_model.class_hvs)`` etc.), so that both packages
compute with identical parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.encoding import NonLin
from repro_torch.core.fragment_model import FragmentModel
from repro_torch.core.hypersense import HyperSenseModel


def _float32_on(device):
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)
    return t


def model_from_arrays(class_hvs, B0, b, *, h: int, w: int, stride: int,
                      t_score: float, t_detection: int,
                      nonlinearity: NonLin = "rff",
                      device: str | torch.device | None = None
                      ) -> HyperSenseModel:
    """A :class:`HyperSenseModel` from ``(2, D)`` class hypervectors, the
    ``(h, D)`` generators and the ``(D,)`` phase, as float32 on ``device``
    (``None`` -> CUDA, raising without it)."""
    t = _float32_on(device)
    B0 = t(B0)
    if B0.shape[0] != h:
        raise ValueError(f"B0 has {B0.shape[0]} generator rows, h={h}")
    return HyperSenseModel(class_hvs=t(class_hvs), B0=B0, b=t(b), h=h, w=w,
                           stride=stride, t_score=float(t_score),
                           t_detection=int(t_detection),
                           nonlinearity=nonlinearity)


def fragment_model_from_arrays(class_hvs, B, b, *,
                               device: str | torch.device | None = None
                               ) -> FragmentModel:
    """A :class:`FragmentModel` from ``(C, D)`` class hypervectors, the
    ``(n, D)`` base and the ``(D,)`` phase, as float32 on ``device``
    (``None`` -> CUDA, raising without it)."""
    t = _float32_on(device)
    class_hvs, B, b = t(class_hvs), t(B), t(b)
    if B.shape[1] != class_hvs.shape[1] or b.shape != (B.shape[1],):
        raise ValueError(f"class_hvs {tuple(class_hvs.shape)}, B "
                         f"{tuple(B.shape)} and b {tuple(b.shape)} do not "
                         f"share one D")
    return FragmentModel(class_hvs=class_hvs, B=B, b=b)
