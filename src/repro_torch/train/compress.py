"""Gradient compression on PyTorch: int8 block quantization with error
feedback. The twin of ``repro.train.compress``.

Each gradient leaf is flattened to float32, padded to a multiple of
``BLOCK`` and cut into blocks; a block's scale is ``max|x| / 127``
(at least 1e-12), its codes ``round(x / scale)`` (half to even, as
``jnp.round``) clipped to ±127 as int8. The quantization's residual, in
the gradient's dtype, is the error-feedback state added to the next
round's gradients before they are quantized (the 1-bit Adam / EF-SGD
lineage), so the bias of the rounding does not accumulate.

    grads_q, ef_state = compress_grads(grads, ef_state)
    grads = decompress_grads(grads_q, like=grads)

As in the reference, nothing in the training loop calls it: it is the
payload a compressed data-parallel all-reduce would carry. Every
function runs on the device of the tensors it is given; the divisions
divide (a Python scalar divisor is made a 0-d tensor, which the card
does not turn into a product with its reciprocal).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.common import leaves, tree_map, true_divide

BLOCK = 256


class QGrad(NamedTuple):
    q: torch.Tensor       # (n_blocks, BLOCK) int8 codes
    scale: torch.Tensor   # (n_blocks,) float32 scales


def _is_qgrad(x) -> bool:
    return isinstance(x, QGrad)


def _quantize(g: torch.Tensor) -> tuple[QGrad, torch.Tensor]:
    """Block-wise symmetric int8 quantization: ``(qgrad, error)``, the
    error in ``g``'s dtype and shape."""
    flat = g.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    blocks = torch.nn.functional.pad(flat, (0, (-n) % BLOCK)).reshape(
        -1, BLOCK)
    scale = true_divide(blocks.abs().amax(dim=1, keepdim=True), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    err = (blocks - deq).reshape(-1)[:n].reshape(g.shape)
    return QGrad(q=q, scale=scale[:, 0]), err.to(g.dtype)


def _dequantize(qg: QGrad, shape, dtype: torch.dtype) -> torch.Tensor:
    deq = qg.q.to(torch.float32) * qg.scale[:, None]
    return deq.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)


def init_error_feedback(grads):
    """Zeros in the structure, shapes and dtypes of ``grads``."""
    return tree_map(torch.zeros_like, grads)


def compress_grads(grads, ef_state):
    """``(tree of QGrad, new error-feedback state)``: ``grads + ef_state``
    quantized leaf by leaf, its residual the new state."""
    out = [_quantize(g + e) for g, e in zip(leaves(grads), leaves(ef_state))]
    qs, errs = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(qs), grads),
            tree_map(lambda _: next(errs), grads))


def decompress_grads(qgrads, like):
    """The dequantized gradients in the shapes and dtypes of ``like``."""
    qs: list = []
    tree_map(qs.append, qgrads, _is_qgrad)
    it = iter([_dequantize(qg, tuple(x.shape), x.dtype)
               for qg, x in zip(qs, leaves(like), strict=True)])
    return tree_map(lambda _: next(it), like)


def compression_ratio(grads) -> float:
    """Payload bytes of the int8 codes and per-block float32 scales
    against float32 gradients (the reference's count: ``size // BLOCK +
    1`` scales a leaf)."""
    sizes = [math.prod(x.shape) for x in leaves(grads)]
    raw = sum(n * 4 for n in sizes)
    comp = sum(n * 1 + (n // BLOCK + 1) * 4 for n in sizes)
    return comp / raw
