"""Shared inputs for the PyTorch-port parity tests (``test_torch_*.py``).

Every input is a ``np.random.default_rng(seed)`` array handed to both
packages — never ``jax.random`` — so the two sides compute on identical
numbers and a change of JAX's PRNG cannot reach the port's tests.
"""

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import hypersense as jhs
from repro_torch.convert import model_from_arrays

#: the reference's cross-platform score tolerance (tests/test_golden.py)
SCORE_ATOL = 5e-5
#: every score a decision rests on must sit this far from t_score
DECISION_MARGIN = 5 * SCORE_ATOL

#: small test geometry: 32x32 frames, 8x8 fragments, stride 4 -> 7x7 windows
H = W = 32
FRAG = 8
STRIDE = 4


def model_arrays(seed: int, D: int, h: int = FRAG):
    rng = np.random.default_rng(seed)
    B0 = rng.standard_normal((h, D)).astype(np.float32)
    b = rng.uniform(0.0, 2 * np.pi, D).astype(np.float32)
    C = rng.standard_normal((2, D)).astype(np.float32)
    return C, B0, b


def models(seed: int, D: int, *, t_score: float = 0.0, t_detection: int = 0,
           h: int = FRAG, w: int = FRAG, stride: int = STRIDE,
           nonlinearity: str = "rff"):
    """The same model in both packages: ``(jax_model, torch_model)``."""
    C, B0, b = model_arrays(seed, D, h)
    jm = jhs.HyperSenseModel(jnp.asarray(C), jnp.asarray(B0), jnp.asarray(b),
                             h, w, stride, t_score=t_score,
                             t_detection=t_detection,
                             nonlinearity=nonlinearity)
    tm = model_from_arrays(np.asarray(jm.class_hvs), np.asarray(jm.B0),
                           np.asarray(jm.b), h=h, w=w, stride=stride,
                           t_score=t_score, t_detection=t_detection,
                           nonlinearity=nonlinearity, device="cpu")
    return jm, tm


def frames(seed: int, n: int, h: int = H, w: int = W):
    """``(n, h, w)`` float32 frames in [0, 1.5]: noise, with a Gaussian
    blob on every other run of frames, and their ``(n,)`` labels."""
    rng = np.random.default_rng(seed)
    out = rng.uniform(0.0, 0.6, (n, h, w))
    labels = (np.arange(n) // 3) % 2
    yy, xx = np.mgrid[:h, :w]
    for i in np.flatnonzero(labels):
        cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
        out[i] += 0.9 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    return np.clip(out, 0.0, 1.5).astype(np.float32), labels.astype(np.int32)


def pick_threshold(scores, lo: float = 0.25, hi: float = 0.75) -> float:
    """A ``t_score`` in the widest gap of ``scores`` between the ``lo`` and
    ``hi`` quantiles."""
    s = np.sort(np.asarray(scores, np.float64))
    lo, hi = int(lo * len(s)), max(int(hi * len(s)), int(lo * len(s)) + 2)
    gaps = np.diff(s[lo:hi])
    i = lo + int(np.argmax(gaps))
    return float((s[i] + s[i + 1]) / 2)


def assert_margin(scores, t_score: float) -> None:
    margin = float(np.abs(np.asarray(scores) - t_score).min())
    assert margin > DECISION_MARGIN, (margin, t_score)


def t(a) -> torch.Tensor:
    """numpy/JAX array -> CPU tensor (same dtype)."""
    return torch.from_numpy(np.array(a))


def partition_sum(x: torch.Tensor) -> torch.Tensor:
    """``(..., n_dt, td)`` -> ``(...)`` in the scoring kernels' order: per
    128-column tile, each thread (warp ``wn``, quad lane ``q``) sums its
    columns ``32 wn + 8 ni + 2 q + e`` in order, the quad combines in a
    butterfly, the 4 warps left to right; the column tiles fold left to
    right (``fold_epilogue``)."""
    n_dt, td = x.shape[-2:]
    parts = []
    for dt in range(n_dt):
        for j0 in range(0, td, 128):
            n = min(128, td - j0)
            cols = torch.zeros(x.shape[:-2] + (128,), dtype=x.dtype)
            cols[..., :n] = x[..., dt, j0:j0 + n]
            warps = []
            for wn in range(4):
                lanes = []
                for q in range(4):
                    v = torch.zeros(x.shape[:-2], dtype=x.dtype)
                    for ni in range(4):
                        for e in range(2):
                            v = v + cols[..., 32 * wn + 8 * ni + 2 * q + e]
                    lanes.append(v)
                warps.append((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
            parts.append(((warps[0] + warps[1]) + warps[2]) + warps[3])
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def within_one_bf16_ulp(got, want) -> bool:
    """Each entry of ``got`` within one bf16 ulp (of the larger magnitude
    of the two) of ``want``'s: the bound for bf16 values rounded from
    float32 sums that two packages add in another order. Tensors or
    arrays."""
    got, want = (np.asarray(x.to(torch.float32) if isinstance(
        x, torch.Tensor) else x, np.float32) for x in (got, want))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(
        mag, np.finfo(np.float32).tiny))) - 7)
    return bool(np.all(np.abs(got - want) <= ulp))
