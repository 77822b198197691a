"""Plain PyTorch oracles, twins of ``repro.kernels.ref``.

The intentionally slow, clear formulation — no reuse tricks — so a kernel
bug cannot hide in a shared shortcut.
"""

from __future__ import annotations

import torch

from repro_torch import pin_fp32_matmul
from repro_torch.core import encoding
from repro_torch.core.encoding import NonLin


def hdc_encode(x: torch.Tensor, B: torch.Tensor, b: torch.Tensor,
               nonlinearity: NonLin = "rff") -> torch.Tensor:
    """(N, n) @ (n, D) + fused nonlinearity -> (N, D). No normalization."""
    with pin_fp32_matmul():
        proj = x.to(torch.float32) @ B.to(torch.float32)
    return encoding.apply_nonlinearity(proj, b.to(torch.float32),
                                       nonlinearity)


def similarity(queries: torch.Tensor, class_hvs: torch.Tensor,
               eps: float = 1e-9) -> torch.Tensor:
    """Cosine class scores: (N, D), (C, D) -> (N, C)."""
    q = queries.to(torch.float32)
    c = class_hvs.to(torch.float32)
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                         min=eps)
    cn = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True),
                         min=eps)
    with pin_fp32_matmul():
        return qn @ cn.T


def fragment_scores(frame: torch.Tensor, class_hvs: torch.Tensor,
                    B0: torch.Tensor, b: torch.Tensor, *, h: int, w: int,
                    stride: int, nonlinearity: NonLin = "rff"
                    ) -> torch.Tensor:
    """Frame -> (my, mx) fragment detection-score map: the naive sliding
    encode + cosine classifier; score = sim(positive) - sim(negative)."""
    hv = encoding.encode_frame_naive(
        frame.to(torch.float32), B0.to(torch.float32), b.to(torch.float32),
        h=h, w=w, stride=stride, nonlinearity=nonlinearity, normalize=True)
    my, mx, dim = hv.shape
    s = similarity(hv.reshape(my * mx, dim), class_hvs)
    return (s[:, 1] - s[:, 0]).reshape(my, mx)
