"""PyTorch port, the cosine classifier's cluster kernel emulated on the CPU
and held against the JAX package.

``csrc/similarity.cu`` runs only on the card, so these tests replay its
order of summation in plain PyTorch:

(a) the chunk plan (``similarity.chunk``), set by D alone: rank ``r`` of
    the ``RANKS``-block cluster owns ``[r * chunk, min(D, (r + 1) *
    chunk))``, ``chunk`` a multiple of ``CHUNK_ALIGN`` floats;
(b) per rank, each lane's fmaf chain over the float4 slots ``v = lane
    (mod 32)`` of the chunk, a slot's four elements in order (one product
    exact in float64, one rounding to float32 per step, standing in for
    ``fmaf``); the warp's shuffle tree (``shfl_down`` by 16, 8, 4, 2, 1);
    the fold of the ranks' partial dots, q.q and c.c left to right in rank
    order; the epilogue ``dot / (max(sqrt(q.q), eps) * max(sqrt(c.c),
    eps))``;

within ``SCORE_ATOL`` of the JAX ``similarity`` in interpret mode, and
bitwise the same for a row at any batch position and a class in any
class subset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SCORE_ATOL, t
from repro.kernels import similarity as jk_sim
from repro_torch.kernels import similarity as tk_sim

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

EPS = 1e-9
LANES = 32

#: (N, D, C): the training path's held-out call, a 7-row call, D % 4 != 0
#: with its one-element second rank, many classes (past one group of 8),
#: and ranks with empty chunks (D = 16: rank 0 owns every element)
SHAPES = [(384, 5000, 2), (7, 5000, 2), (50, 300, 2), (257, 129, 3),
          (9, 130, 17), (40, 300, 33), (3, 16, 1)]
#: D for the plan: empty ranks, D % 4 != 0, the paper's D, several tiles
PLAN_DS = [1, 16, 127, 128, 129, 130, 300, 1000, 1024, 1025, 4999, 5000,
           8192, 8193, 20001]


def ranks(D):
    """Each rank's ``(lo, hi)`` of D under the kernel's chunk plan."""
    ch = tk_sim.chunk(D)
    return [(min(D, r * ch), min(D, (r + 1) * ch))
            for r in range(tk_sim.RANKS)]


def lane_chains(a, b):
    """``(..., L), (..., L) -> (..., 32)``: lane l's fmaf chain over
    elements ``128 s + 4 l + j`` for s, then j, in order; the tail padded
    with zeros, which add nothing."""
    L = a.shape[-1]
    pad = -L % (4 * LANES)
    a = torch.nn.functional.pad(a, (0, pad)).reshape(
        *a.shape[:-1], -1, LANES, 4)
    b = torch.nn.functional.pad(b, (0, pad)).reshape(
        *b.shape[:-1], -1, LANES, 4)
    acc = torch.zeros(a.shape[:-3] + (LANES,), dtype=torch.float32)
    for s in range(a.shape[-3]):
        for j in range(4):
            prod = a[..., s, :, j].double() * b[..., s, :, j].double()
            acc = (acc.double() + prod).float()
    return acc


def warp_tree(v):
    """``(..., 32) -> (...)``: lane 0 after ``shfl_down`` by 16, 8, 4, 2,
    1, each step ``v[l] + v[l + o]``."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def rank_fold(parts):
    """The ranks' partials added left to right in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def emulated_similarity(q, c, eps=EPS):
    """The kernel's scores ``(N, C)`` of float32 ``q (N, D)``, ``c (C,
    D)``."""
    dots, qqs, ccs = [], [], []
    for lo, hi in ranks(q.shape[1]):
        qs, cs = q[:, lo:hi], c[:, lo:hi]
        dots.append(warp_tree(lane_chains(qs[:, None, :], cs[None, :, :])))
        qqs.append(warp_tree(lane_chains(qs, qs)))
        ccs.append(warp_tree(lane_chains(cs, cs)))
    dot, qq, cc = rank_fold(dots), rank_fold(qqs), rank_fold(ccs)
    qn = torch.clamp(torch.sqrt(qq), min=eps)[:, None]
    cn = torch.clamp(torch.sqrt(cc), min=eps)[None, :]
    return dot / (qn * cn)


def inputs(seed, n, d, c):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((c, d)).astype(np.float32))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0,
                               atol=SCORE_ATOL)


# ---------------------------------------------------------------------------
# (a) the chunk plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", PLAN_DS)
def test_plan_depends_on_d_only_and_covers_d_once(D):
    ch = tk_sim.chunk(D)                           # takes D alone
    per = -(-D // tk_sim.RANKS)
    assert ch % tk_sim.CHUNK_ALIGN == 0
    assert per <= ch < per + tk_sim.CHUNK_ALIGN
    covered = np.zeros(D, np.int64)
    for lo, hi in ranks(D):
        covered[lo:hi] += 1
    assert (covered == 1).all()
    owned = [r for r, (lo, hi) in enumerate(ranks(D)) if hi > lo]
    assert owned == list(range(len(owned)))        # empty ranks come last


# ---------------------------------------------------------------------------
# (b) the kernel's order against JAX, and its bitwise invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_order_matches_jax(shape):
    q, c = inputs(17, *shape)
    want = jk_sim.similarity(jnp.asarray(q), jnp.asarray(c), interpret=True)
    got = emulated_similarity(t(q), t(c))
    assert got.shape == want.shape == shape[::2]
    close(got, want)
    close(got, tk_sim.similarity(t(q), t(c)))      # the CPU path


def test_emulated_order_clamps_zero_rows_like_jax():
    q, c = inputs(18, 4, 300, 3)
    q[1] = 0.0
    c[2] = 0.0
    want = jk_sim.similarity(jnp.asarray(q), jnp.asarray(c), interpret=True)
    got = emulated_similarity(t(q), t(c))
    close(got, want)
    assert (got[1] == 0).all() and (got[:, 2] == 0).all()


@pytest.mark.parametrize("D", [5000, 129])
def test_row_is_bitwise_the_same_at_any_batch_position(D):
    q, c = inputs(19, 37, D, 2)
    alone = emulated_similarity(t(q[3:10]), t(c))          # N = 7
    # the same rows at 20..26 of a 37-row call
    moved = np.concatenate([q[10:30], q[3:10], q[30:], q[:3]])
    inside = emulated_similarity(t(moved), t(c))
    assert inside.shape[0] == 37
    assert torch.equal(alone, inside[20:27])


@pytest.mark.parametrize("D", [5000, 130])
def test_class_column_is_bitwise_the_same_in_any_class_subset(D):
    q, c = inputs(20, 9, D, 17)
    two = emulated_similarity(t(q), t(c[[4, 11]]))
    many = emulated_similarity(t(q), t(c))
    assert torch.equal(two, many[:, [4, 11]])
