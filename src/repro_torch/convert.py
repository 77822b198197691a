"""Carry a HyperSense model's, a Fragment model's, a detector's or a
baseline's weights across into the port.

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
from repro_torch.models import common
from repro_torch.sensing.baselines import MLP, TinyConv


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


def detector_params_from_arrays(tree, *,
                                device: str | torch.device | None = None
                                ) -> dict:
    """The port's detector parameters from the reference's
    ``init_detector_params`` tree as numpy arrays: the same nested dicts and
    leaf names (``{"backbone": {..., "layers": {"attn": {"wq": (L, d, h,
    hd), ...}}}, "embedder": {"proj", "pos"}}``, layers stacked on a leading
    axis), each leaf float32 on ``device`` (``None`` -> CUDA, raising
    without it)."""
    if set(tree) != {"backbone", "embedder"}:
        raise ValueError(f"a detector tree has 'backbone' and 'embedder', "
                         f"got {sorted(tree)}")
    return common.tree_map(_float32_on(device), tree)


def baseline_from_arrays(tree, *, kind: str,
                         device: str | torch.device | None = None
                         ) -> MLP | TinyConv:
    """A Table I baseline from the reference's parameter tree as numpy
    arrays, float32 on ``device`` (``None`` -> CUDA, raising without it).

    ``kind="mlp"``: ``init_mlp``'s list of ``{"w": (n_in, n_out), "b"}``;
    ``kind="tiny_conv"``: ``init_tiny_conv``'s ``{"convs": [{"w": (kh, kw,
    cin, cout), "b"}, ...], "head": {"w", "b"}}``. Dense weights become
    ``(n_out, n_in)`` and convolution kernels ``(cout, cin, kh, kw)``.
    """
    def dense(layer):
        return {"w": np.asarray(layer["w"]).T, "b": np.asarray(layer["b"])}

    if kind == "mlp":
        arrays = [dense(layer) for layer in tree]
        module = MLP([arrays[0]["w"].shape[1]]
                     + [a["w"].shape[0] for a in arrays], device=device)
    elif kind == "tiny_conv":
        arrays = {"convs": [{"w": np.transpose(np.asarray(c["w"]),
                                               (3, 2, 0, 1)),
                             "b": np.asarray(c["b"])}
                            for c in tree["convs"]],
                  "head": dense(tree["head"])}
        module = TinyConv([c["w"].shape[0] for c in arrays["convs"]],
                          device=device)
    else:
        raise ValueError(f"unknown baseline kind {kind!r}")
    t = _float32_on(device)
    with torch.no_grad():
        for p, a in zip(common.leaves(module.tree()), common.leaves(arrays)):
            if tuple(p.shape) != a.shape:
                raise ValueError(f"a {kind} leaf of shape {a.shape} does not "
                                 f"fit {tuple(p.shape)}")
            p.copy_(t(a))
    return module
