"""HDC fragment encoding against the permutation base, on PyTorch.

Twin of ``repro.kernels.hdc_encode_perm``: encodes flattened fragments
``(N, h*w)`` against the base generated from its ``h`` generator rows
``B0 (h, D)`` (paper Eq. 1, ``B[r*w + j] = roll(B0[r], -j)``), without
ever forming the expanded ``(h*w, D)`` base (184 MB at the paper's
h = w = 96, D = 5000; the generators are 1.9 MB). Equal to
``hdc_encode(x, flat_perm_base(B0, w), b)``.

:func:`hdc_encode_perm` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/hdc_encode_perm.cu``; on a CPU tensor it runs
the plain version :func:`hdc_encode_perm_plain`. Unlike the TPU wrapper,
which asserts ``D % block_d == 0`` and so refuses D = 5000 at its default
``block_d``, the kernel takes any ``D`` and any ``h*w``.
"""

from __future__ import annotations

import torch

from repro_torch.core.encoding import SHIFT, NonLin, flat_perm_base
from repro_torch.kernels import _build
from repro_torch.kernels.hdc_encode import (check_encode_args, f32,
                                            hdc_encode_plain)
from repro_torch.kernels.sliding_scores import NONLINEARITIES

#: kernel launches made by :func:`hdc_encode_perm`
LAUNCHES = 0


def hdc_encode_perm_plain(x: torch.Tensor, B0: torch.Tensor, b: torch.Tensor,
                          *, w: int, nonlinearity: NonLin = "rff"
                          ) -> torch.Tensor:
    """Plain PyTorch version: :func:`hdc_encode_plain` against the expanded
    base ``flat_perm_base(B0, w)``."""
    return hdc_encode_plain(x, flat_perm_base(B0, w), b,
                            nonlinearity=nonlinearity)


def hdc_encode_perm(x: torch.Tensor, B0: torch.Tensor, b: torch.Tensor, *,
                    h: int, w: int, nonlinearity: NonLin = "rff",
                    block_n: int = 128, block_d: int = 512,
                    block_k: int = 256) -> torch.Tensor:
    """Encode flattened fragments ``(N, h*w)`` against the permutation base
    of ``B0 (h, D)`` -> ``(N, D)`` in ``x.dtype``. No normalization inside.

    A CUDA tensor launches ``csrc/hdc_encode_perm.cu`` (or raises); a CPU
    tensor runs :func:`hdc_encode_perm_plain`. The block sizes are the TPU
    kernel's tiling, taken so calls read like the JAX ones.
    """
    global LAUNCHES
    del block_n, block_d, block_k
    assert SHIFT == -1, "the kernel builds roll(B0[r], -j)"
    if B0.ndim != 2 or B0.shape[0] != h:
        raise ValueError(f"B0 must be ({h}, D), got {tuple(B0.shape)}")
    D = B0.shape[1]
    check_encode_args(x, B0, b, h * w, D, nonlinearity)
    if x.device.type == "cpu":
        return hdc_encode_perm_plain(x, B0, b, w=w,
                                     nonlinearity=nonlinearity)
    lib = _build.load("hdc_encode_perm")
    N = x.shape[0]
    xf, B0f, bf = f32(x), f32(B0), f32(b)
    out = torch.empty((N, D), device=x.device)
    if N and D:
        err = lib.hdc_encode_perm_f32(xf.data_ptr(), B0f.data_ptr(),
                                      bf.data_ptr(), out.data_ptr(), N, h, w,
                                      D, NONLINEARITIES[nonlinearity],
                                      _build.stream_ptr())
        _build.check(err, "hdc_encode_perm_f32")
        LAUNCHES += 1
    return out.to(x.dtype)
