"""Fused HDC fragment encoding on PyTorch.

Twin of ``repro.kernels.hdc_encode``: ``phi(x) = nonlin(x @ B, b)`` as one
tiled matmul with the nonlinearity (``cos(p + b) * sin(p)``, ``sign`` or
linear) fused into the epilogue, so the projection never round-trips to
device memory. No normalization inside; the output has ``x``'s dtype, and
bf16 operands are computed in float32, as the TPU kernel does.

:func:`hdc_encode` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/hdc_encode.cu``; on a CPU tensor it runs the
plain version :func:`hdc_encode_plain`, which the tests hold against the
JAX package. The kernel multiplies on the TF32 tensor cores in 3xTF32
(each operand split into two TF32 parts, three products), which keeps
float32 accuracy.
"""

from __future__ import annotations

import torch

from repro_torch.core.encoding import NonLin
from repro_torch.kernels import _build, ref
from repro_torch.kernels.sliding_scores import NONLINEARITIES, _check_device

#: kernel launches made by :func:`hdc_encode` (one per call on a CUDA tensor)
LAUNCHES = 0


def hdc_encode_plain(x: torch.Tensor, B: torch.Tensor, b: torch.Tensor, *,
                     nonlinearity: NonLin = "rff") -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``(N, K) @ (K, D)`` in float32
    and the nonlinearity, cast to ``x.dtype``."""
    return ref.hdc_encode(x, B, b, nonlinearity).to(x.dtype)


def check_encode_args(x: torch.Tensor, base: torch.Tensor, b: torch.Tensor,
                      K: int, D: int, nonlinearity: str) -> None:
    """Shapes, devices and the nonlinearity of an encoder call, for a
    ``(K, D)`` base (``base`` is the dense base or its generators)."""
    _check_device(x)
    if base.device != x.device or b.device != x.device:
        raise ValueError(f"fragments on {x.device}, base on {base.device}, "
                         f"phase on {b.device}")
    if nonlinearity not in NONLINEARITIES:
        raise ValueError(f"unknown nonlinearity {nonlinearity!r}")
    if x.ndim != 2 or x.shape[1] != K or b.shape != (D,):
        raise ValueError(f"encode takes (N, {K}) fragments and a ({D},) "
                         f"phase, got {tuple(x.shape)} and "
                         f"{tuple(b.shape)}")


def f32(a: torch.Tensor) -> torch.Tensor:
    """A contiguous float32 operand for a kernel."""
    return a.to(torch.float32).contiguous()


def hdc_encode(x: torch.Tensor, B: torch.Tensor, b: torch.Tensor, *,
               nonlinearity: NonLin = "rff", block_n: int = 128,
               block_d: int = 512, block_k: int = 512) -> torch.Tensor:
    """Fused encode ``(N, K) @ (K, D)`` + pointwise nonlinearity ->
    ``(N, D)`` in ``x.dtype``.

    A CUDA tensor launches ``csrc/hdc_encode.cu`` (or raises); a CPU tensor
    runs :func:`hdc_encode_plain`. The block sizes are the TPU kernel's
    tiling, taken so calls read like the JAX ones; the CUDA kernel picks
    its own output tiles (128 x 160, or 128 x 128 where the narrower tile
    lets the grid finish sooner on the card's SMs).
    """
    global LAUNCHES
    del block_n, block_d, block_k
    if B.ndim != 2:
        raise ValueError(f"B must be (K, D), got {tuple(B.shape)}")
    K, D = B.shape
    check_encode_args(x, B, b, K, D, nonlinearity)
    if x.device.type == "cpu":
        return hdc_encode_plain(x, B, b, nonlinearity=nonlinearity)
    lib = _build.load("hdc_encode")
    N = x.shape[0]
    xf, Bf, bf = f32(x), f32(B), f32(b)
    out = torch.empty((N, D), device=x.device)
    if N and D:
        err = lib.hdc_encode_f32(xf.data_ptr(), Bf.data_ptr(), bf.data_ptr(),
                                 out.data_ptr(), N, K, D,
                                 NONLINEARITIES[nonlinearity],
                                 _build.stream_ptr())
        _build.check(err, "hdc_encode_f32")
        LAUNCHES += 1
    return out.to(x.dtype)
