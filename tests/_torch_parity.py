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
