"""HDC encoding for HyperSense (paper §III-A, §IV-B) on PyTorch.

Twin of ``repro.core.encoding``. Permutation-structured bases (paper
Eq. 1): for an ``h x w`` fragment only the ``h`` first-column
hypervectors ``B0 (h, D)`` are random; column ``j`` of base row ``r`` is
``roll(B0[r], j * SHIFT)``. The encoding is ``phi(x) = cos(xB + b) *
sin(xB)`` of the L2-normalized flattened fragment.

:func:`encode_frame_naive` and :func:`encode_frame_reuse` are the two
oracle frame encoders (every fragment encoded on its own, and the paper's
computation reuse as a prefix sum over rolled products), batched by
:func:`encode_frames`; the streaming hot path never calls them — it runs
the fused kernels of :mod:`repro_torch.kernels`.
"""

from __future__ import annotations

import math
from typing import Literal

import torch

from repro_torch import pin_fp32_matmul

#: rotation step used to generate neighbouring-column bases (paper: left shift)
SHIFT = -1

NonLin = Literal["rff", "linear", "sign"]


# ---------------------------------------------------------------------------
# Base generation
# ---------------------------------------------------------------------------

def make_iid_base(generator: torch.Generator, n_features: int, dim: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """i.i.d. Gaussian base ``B (n, D)`` and uniform phase ``b (D,)`` ~
    U(0, 2 pi) (paper §III-A), drawn on the generator's device."""
    return make_perm_base_rows(generator, n_features, dim)


def make_perm_base_rows(generator: torch.Generator, h: int, dim: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``h`` random generator hypervectors ``B0 (h, D)`` ~ N(0, 1) and
    the phase ``b (D,)`` ~ U(0, 2 pi), drawn on the generator's device."""
    dev = generator.device
    B0 = torch.randn((h, dim), generator=generator, device=dev,
                     dtype=torch.float32)
    b = torch.rand((dim,), generator=generator, device=dev,
                   dtype=torch.float32) * (2 * math.pi)
    return B0, b


def expand_perm_base(B0: torch.Tensor, w: int, shift: int = SHIFT
                     ) -> torch.Tensor:
    """Materialize the full ``(h, w, D)`` base: ``B[r, j] = roll(B0[r],
    j * shift)`` — Eq. (1) of the paper."""
    return torch.stack([torch.roll(B0, j * shift, dims=-1)
                        for j in range(w)], dim=1)


def flat_perm_base(B0: torch.Tensor, w: int, shift: int = SHIFT
                   ) -> torch.Tensor:
    """``(h*w, D)`` base for encoding flattened (row-major) fragments."""
    h, dim = B0.shape
    return expand_perm_base(B0, w, shift).reshape(h * w, dim)


# ---------------------------------------------------------------------------
# Pointwise nonlinearity
# ---------------------------------------------------------------------------

def apply_nonlinearity(proj: torch.Tensor, b: torch.Tensor,
                       kind: NonLin = "rff") -> torch.Tensor:
    """``phi`` from the projection ``xB`` (paper: cos(xB+b) * sin(xB))."""
    if kind == "rff":
        return torch.cos(proj + b) * torch.sin(proj)
    if kind == "linear":
        return proj
    if kind == "sign":
        return torch.sign(proj)
    raise ValueError(f"unknown nonlinearity {kind!r}")


# ---------------------------------------------------------------------------
# Fragment encoding (training path, §III-C steps 2-3)
# ---------------------------------------------------------------------------

def normalize_flat(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalize flattened fragments along the last axis (paper step 2)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def encode_fragments(frags: torch.Tensor, B: torch.Tensor, b: torch.Tensor,
                     *, nonlinearity: NonLin = "rff",
                     normalize: bool = True) -> torch.Tensor:
    """Encode ``(N, h, w)`` (or pre-flattened ``(N, n)``) fragments ->
    ``(N, D)`` hypervectors."""
    if frags.ndim > 2:
        frags = frags.reshape(frags.shape[0], -1)
    x = normalize_flat(frags) if normalize else frags
    with pin_fp32_matmul():
        proj = x.to(torch.float32) @ B
    return apply_nonlinearity(proj, b, nonlinearity)


# ---------------------------------------------------------------------------
# Sliding-window frame encoding — the two oracles (§III-C steps 6-7)
# ---------------------------------------------------------------------------

def num_windows(n: int, w: int, stride: int) -> int:
    """Number of in-bounds sliding windows along one axis."""
    return max(0, (n - w) // stride + 1)


def extract_fragments(frame: torch.Tensor, h: int, w: int, stride: int
                      ) -> torch.Tensor:
    """``(H, W) -> (my, mx, h, w)`` sliding-window crops (no padding; the
    out-of-bounds remainder is skipped, paper Fig. 13a)."""
    return frame.unfold(0, h, stride).unfold(1, w, stride)


def encode_frame_naive(frame: torch.Tensor, B0: torch.Tensor,
                       b: torch.Tensor, *, h: int, w: int, stride: int,
                       nonlinearity: NonLin = "rff",
                       normalize: bool = True) -> torch.Tensor:
    """Reference sliding-window encoder ``(H, W) -> (my, mx, D)``: every
    fragment encoded independently against the materialized base."""
    frags = extract_fragments(frame, h, w, stride)
    my, mx = frags.shape[:2]
    flat = frags.reshape(my * mx, h * w)
    hv = encode_fragments(flat, flat_perm_base(B0, w), b,
                          nonlinearity=nonlinearity, normalize=normalize)
    return hv.reshape(my, mx, -1)


def encode_frame_reuse(frame: torch.Tensor, B0: torch.Tensor,
                       b: torch.Tensor, *, h: int, w: int, stride: int,
                       nonlinearity: NonLin = "rff",
                       normalize: bool = True) -> torch.Tensor:
    """Computation-reuse sliding-window encoder ``(H, W) -> (my, mx, D)``.

    Per base row ``r``: rolled products ``A[y, i] = frame[y, i] *
    roll(B0[r], i*SHIFT)``, an exclusive prefix sum ``P`` along ``i``,
    every fragment row-sum ``P[kx+w] - P[kx]`` rolled back by ``kx``, and
    the ``h`` diagonals summed per fragment; window L2 norms from a
    summed-area table of ``x^2``. Equal to :func:`encode_frame_naive` up to
    float rounding.
    """
    H, W = frame.shape
    dim = B0.shape[-1]
    dev = frame.device
    my, mx = num_windows(H, h, stride), num_windows(W, w, stride)
    kx = torch.arange(mx, device=dev) * stride
    ky = torch.arange(my, device=dev) * stride
    frame = frame.to(torch.float32)
    d = torch.arange(dim, device=dev)
    # roll(v, i*SHIFT)[d] = v[(d - i*SHIFT) % dim]
    fwd = (d[None, :] - SHIFT * torch.arange(W, device=dev)[:, None]) % dim
    # roll back by +kx*(-SHIFT): out[d] = v[(d - (-SHIFT)*kx) % dim]
    back = (d[None, :] - (-SHIFT) * kx[:, None]) % dim          # (mx, D)

    proj = torch.zeros((my, mx, dim), dtype=torch.float32, device=dev)
    for r in range(h):
        A = frame[:, :, None] * B0[r][fwd][None]                 # (H, W, D)
        P = torch.cat([torch.zeros((H, 1, dim), device=dev),
                       torch.cumsum(A, dim=1)], dim=1)            # (H, W+1, D)
        seg = P[:, kx + w, :] - P[:, kx, :]                      # (H, mx, D)
        seg = torch.gather(seg, 2, back[None].expand(H, mx, dim))
        proj = proj + seg[ky + r]

    if normalize:
        sq = torch.cumsum(torch.cumsum(frame * frame, dim=0), dim=1)
        sq = torch.nn.functional.pad(sq, (1, 0, 1, 0))
        win = (sq[ky[:, None] + h, kx[None, :] + w]
               - sq[ky[:, None] + h, kx[None, :]]
               - sq[ky[:, None], kx[None, :] + w]
               + sq[ky[:, None], kx[None, :]])                     # (my, mx)
        norm = torch.sqrt(torch.clamp(win, min=1e-16))
        proj = proj / torch.clamp(norm, min=1e-8)[:, :, None]

    return apply_nonlinearity(proj, b, nonlinearity)


def encode_frames(frames: torch.Tensor, B0: torch.Tensor, b: torch.Tensor,
                  *, h: int, w: int, stride: int,
                  nonlinearity: NonLin = "rff", normalize: bool = True,
                  reuse: bool = True) -> torch.Tensor:
    """Batched frame encoding ``(N, H, W) -> (N, my, mx, D)`` through
    :func:`encode_frame_reuse` (``reuse=True``) or
    :func:`encode_frame_naive`, one frame at a time, so that no more than
    one frame's ``(H, W, D)`` products (328 MB at 128x128, D=5000) are
    alive at once."""
    fn = encode_frame_reuse if reuse else encode_frame_naive
    H, W = frames.shape[1:]
    out = torch.empty((frames.shape[0], num_windows(H, h, stride),
                       num_windows(W, w, stride), B0.shape[-1]),
                      dtype=torch.float32, device=frames.device)
    for i, frame in enumerate(frames):
        out[i] = fn(frame, B0, b, h=h, w=w, stride=stride,
                    nonlinearity=nonlinearity, normalize=normalize)
    return out
