"""HyperSense on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``repro`` to PyTorch, with the TPU's Pallas
kernels rewritten by hand in CUDA C++ for ``sm_90a``. It mirrors the JAX
package's layout (``repro_torch.kernels.sliding_scores`` is the twin of
``repro.kernels.sliding_scores``, and so on) and imports neither JAX nor
anything of ``repro``.

Device rule: every entry point runs on the card unless the caller asks for
the CPU. ``device=None`` means ``"cuda"`` and raises when CUDA is absent;
there is no silent CPU fallback. On a CPU tensor a kernel wrapper runs its
plain PyTorch version (the twin the tests hold against JAX); on a CUDA
tensor it launches the hand-written kernel or raises.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raising without CUDA); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def pin_fp32_matmul() -> Iterator[None]:
    """Inside the scope, float32 matmuls and cuDNN convolutions run in full
    float32 on the card (no TF32); on exit, exceptions included, the
    caller's ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` are back as they were (cuDNN's
    defaults to True, so a convolution would run in TF32 unasked).

    TF32 keeps about three decimal digits, far outside the 5e-5 score
    tolerance the port is held to; every module of the port that calls a
    matmul or a convolution runs it in this scope, and changes no
    process-wide flag. The encoder kernels' tensor-core path is not this
    TF32: they split each float32 operand into two TF32 parts and sum
    three products (3xTF32, ``kernels/csrc/encode_common.cuh``), which
    keeps float32 accuracy.
    cuBLAS reads the flag when a call is made or recorded into a CUDA
    graph, so a graph is captured inside the scope.
    """
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before


@contextlib.contextmanager
def pin_detector_matmul() -> Iterator[None]:
    """:func:`pin_fp32_matmul`'s scope (the attention scores are float32 in
    every config) with bf16 products reduced in float32 as well, as the
    reference's bf16 dot accumulates; on exit both flags are the
    caller's again."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with pin_fp32_matmul():
            yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


@contextlib.contextmanager
def pin_conv() -> Iterator[None]:
    """:func:`pin_fp32_matmul`'s scope with cuDNN held to deterministic
    algorithms and no autotuning, so that a convolution's backward pass
    gives the same bits run to run; on exit, exceptions included, the
    caller's ``deterministic`` and ``benchmark`` are back as well."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with pin_fp32_matmul():
            yield
    finally:
        cudnn.deterministic, cudnn.benchmark = before
