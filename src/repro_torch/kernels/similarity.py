"""Fused cosine-similarity classifier on PyTorch.

Twin of ``repro.kernels.similarity``: cosine class scores of query
hypervectors ``(N, D)`` against class hypervectors ``(C, D)`` -> ``(N, C)``
in float32, as ``dots / (max(sqrt(q.q), eps) * max(sqrt(c.c), eps))``.

:func:`similarity` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/similarity.cu``; on a CPU tensor it runs the
plain version :func:`similarity_plain`, which the tests hold against the
JAX package.
"""

from __future__ import annotations

import torch

from repro_torch import pin_fp32_matmul
from repro_torch.kernels import _build
from repro_torch.kernels.sliding_scores import _check_device

#: calls of :func:`similarity` on a CUDA tensor (each launches the kernel
#: once per block of :data:`MAX_CLASSES` classes)
LAUNCHES = 0

#: most classes one launch takes (``kMaxClasses`` in ``csrc/similarity.cu``)
MAX_CLASSES = 8


def similarity_plain(queries: torch.Tensor, class_hvs: torch.Tensor, *,
                     eps: float = 1e-9) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the dots and both sums of
    squares, then the reference's epilogue."""
    pin_fp32_matmul()
    q = queries.to(torch.float32)
    c = class_hvs.to(torch.float32)
    qn = torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)),
                     min=eps)                                     # (N, 1)
    cn = torch.clamp(torch.sqrt(torch.sum(c * c, dim=-1)), min=eps)  # (C,)
    return (q @ c.T) / (qn * cn)


def _launch(q: torch.Tensor, c: torch.Tensor, eps: float) -> torch.Tensor:
    """One kernel launch per block of up to ``MAX_CLASSES`` classes, each
    writing its columns of ``out``."""
    lib = _build.load("similarity")
    N, D = q.shape
    C = c.shape[0]
    out = torch.empty((N, C), device=q.device)
    if N == 0:
        return out
    cc = torch.empty((C,), device=q.device)
    for c0 in range(0, C, MAX_CLASSES):
        cb = min(MAX_CLASSES, C - c0)
        vec = int(D % 4 == 0 and q.data_ptr() % 16 == 0
                  and c[c0].data_ptr() % 16 == 0)
        err = lib.similarity_f32(q.data_ptr(), c[c0].data_ptr(),
                                 cc[c0:].data_ptr(), out[:, c0:].data_ptr(),
                                 N, D, cb, C, vec, eps, _build.stream_ptr())
        _build.check(err, "similarity_f32")
    return out


def similarity(queries: torch.Tensor, class_hvs: torch.Tensor, *,
               block_n: int = 256, block_d: int = 1024,
               eps: float = 1e-9) -> torch.Tensor:
    """Cosine class scores ``(N, D), (C, D) -> (N, C)`` in float32.

    A CUDA tensor launches ``csrc/similarity.cu`` (or raises); a CPU
    tensor runs :func:`similarity_plain`. ``block_n``/``block_d`` are the
    TPU kernel's tiling, taken so calls read like the JAX ones; the CUDA
    kernel picks its own (one warp per query row).
    """
    global LAUNCHES
    del block_n, block_d
    _check_device(queries)
    if queries.ndim != 2 or class_hvs.ndim != 2 \
            or queries.shape[1] != class_hvs.shape[1]:
        raise ValueError(f"similarity takes (N, D) queries and (C, D) "
                         f"classes, got {tuple(queries.shape)} and "
                         f"{tuple(class_hvs.shape)}")
    if class_hvs.device != queries.device:
        raise ValueError(f"queries on {queries.device}, classes on "
                         f"{class_hvs.device}")
    if queries.device.type == "cpu":
        return similarity_plain(queries, class_hvs, eps=eps)
    if class_hvs.shape[0] < 1:
        raise ValueError("the similarity kernel takes at least one class")
    out = _launch(queries.to(torch.float32).contiguous(),
                  class_hvs.to(torch.float32).contiguous(), eps)
    LAUNCHES += 1
    return out
