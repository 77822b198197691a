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

#: calls of :func:`similarity` on a CUDA tensor (each is one cluster
#: launch, whatever the class count)
LAUNCHES = 0

#: blocks per cluster, splitting D (``kRanks`` in ``csrc/similarity.cu``)
RANKS = 8
#: a chunk is a multiple of this many floats: 32 lanes x float4
CHUNK_ALIGN = 128


def chunk(D: int) -> int:
    """Floats of D each cluster rank owns (``similarity_chunk`` in
    ``csrc/similarity.cu``): ``roundup(ceil(D / RANKS), CHUNK_ALIGN)``.
    Rank ``r`` owns ``[r * chunk, min(D, (r + 1) * chunk))``; the plan is
    set by D alone, so every sum of the kernel has one order per D."""
    per = -(-D // RANKS)
    return -(-per // CHUNK_ALIGN) * CHUNK_ALIGN


def similarity_plain(queries: torch.Tensor, class_hvs: torch.Tensor, *,
                     eps: float = 1e-9) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the dots and both sums of
    squares, then the reference's epilogue."""
    q = queries.to(torch.float32)
    c = class_hvs.to(torch.float32)
    qn = torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)),
                     min=eps)                                     # (N, 1)
    cn = torch.clamp(torch.sqrt(torch.sum(c * c, dim=-1)), min=eps)  # (C,)
    with pin_fp32_matmul():
        return (q @ c.T) / (qn * cn)


def _launch(q: torch.Tensor, c: torch.Tensor, eps: float) -> torch.Tensor:
    """One cluster launch for every query row and class."""
    lib = _build.load("similarity")
    N, D = q.shape
    C = c.shape[0]
    out = torch.empty((N, C), device=q.device)
    if N == 0:
        return out
    bulk = int(D % 4 == 0 and q.data_ptr() % 16 == 0
               and c.data_ptr() % 16 == 0)
    _build.check(lib.similarity_f32(q.data_ptr(), c.data_ptr(),
                                    out.data_ptr(), N, D, C, bulk, eps,
                                    _build.stream_ptr()), "similarity_f32")
    return out


def similarity(queries: torch.Tensor, class_hvs: torch.Tensor, *,
               block_n: int = 256, block_d: int = 1024,
               eps: float = 1e-9) -> torch.Tensor:
    """Cosine class scores ``(N, D), (C, D) -> (N, C)`` in float32.

    A CUDA tensor launches ``csrc/similarity.cu`` (or raises); a CPU
    tensor runs :func:`similarity_plain`. ``block_n``/``block_d`` are the
    TPU kernel's tiling, taken so calls read like the JAX ones; the CUDA
    kernel splits D by :func:`chunk` across a cluster of :data:`RANKS`
    blocks, one warp per query row.
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
