"""Fundamental hyperdimensional-computing operations (paper §III-A).

PyTorch twin of ``repro.core.hdc``. Hypervectors are ``(..., D)`` tensors;
bundling, binding, permutation and the similarity measure used throughout
HyperSense.
"""

from __future__ import annotations

import torch

from repro_torch import pin_fp32_matmul


def bundle(*hvs: torch.Tensor) -> torch.Tensor:
    """Bundling (+): element-wise addition — cognitive *memorization*."""
    out = hvs[0]
    for h in hvs[1:]:
        out = out + h
    return out


def bind(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Binding (*): element-wise multiplication — cognitive *association*."""
    return h1 * h2


def permute(h: torch.Tensor, shift: int = 1, axis: int = -1) -> torch.Tensor:
    """Permutation (rho): cyclic rotation of vector elements."""
    return torch.roll(h, shift, dims=axis)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """delta(a, b): cosine similarity along the last (hyperdimension) axis."""
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(
        b, dim=-1)
    return num / torch.clamp(den, min=eps)


def class_scores(queries: torch.Tensor, class_hvs: torch.Tensor,
                 eps: float = 1e-9) -> torch.Tensor:
    """Cosine similarity of ``(N, D)`` queries against ``(C, D)`` classes
    -> ``(N, C)``."""
    qn = queries / torch.clamp(
        torch.linalg.vector_norm(queries, dim=-1, keepdim=True), min=eps)
    cn = class_hvs / torch.clamp(
        torch.linalg.vector_norm(class_hvs, dim=-1, keepdim=True), min=eps)
    with pin_fp32_matmul():
        return qn @ cn.T


def hamming_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalized agreement of sign-quantized hypervectors (bipolar HDC)."""
    return (torch.sign(a) == torch.sign(b)).to(torch.float32).mean(dim=-1)
