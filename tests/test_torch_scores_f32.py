"""PyTorch port, the float scorer's tensor-core design emulated on the CPU
and held against the JAX package.

``csrc/sliding_scores.cu`` runs only on the card, so these tests replay its
index maps and its arithmetic in plain PyTorch:

(a) the paper's reuse as GEMMs: with ``g = gcd(stride, w)`` the frame
    columns ``u < last = (mx-1)*stride + w`` fall into blocks of ``g``; per
    block ``q`` one product ``A_q (N*my, h*g) @ B_q (h*g, 128)``, A read
    straight from the frames and B the Hankel view ``slab[dt, r, q*g + c +
    j]``, its depth zero-padded to the 32-deep K step; each step's 3xTF32
    products (operands split into ``big = tf32(v)``, ``small = tf32(v -
    big)``, ``big*small + small*big + big*big``) summed into a fresh
    partial that joins a float32 running sum ``P`` with one add; a window
    closes on a block boundary as ``P[end] - P[start]``, its start's
    ``P`` kept from when the window opened. A block of the kernel holds
    ``WINDOWS_PER_BLOCK`` consecutive windows and starts ``P`` at the
    first one's start.
(b) the window norms summed directly per window, the epilogue's column
    partition (``COL_TILE`` columns per partial, summed per thread, across
    a quad, then across the warps) and the left-to-right fold, within
    ``SCORE_ATOL`` of the JAX ``fragment_scores_batch`` in interpret mode,
    and bitwise the same for a frame alone and inside a batch.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SCORE_ATOL, model_arrays, partition_sum, t
from repro.kernels import sliding_scores as jss
from repro_torch.core.encoding import apply_nonlinearity
from repro_torch.kernels import sliding_scores as tss

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

#: (H, W, h, w, stride): the test geometry's g = 4, odd strides with
#: g = 3 and g = 1 (a ragged depth, h*g = 5) and W not a multiple of 4,
#: and windows that do not overlap (w = stride)
SHAPES = [(32, 32, 8, 8, 4), (27, 29, 6, 9, 3), (21, 23, 5, 7, 3),
          (12, 41, 4, 4, 4)]
BLOCK_D = 128
#: 256 -> two 128-wide tiles; 200 -> one 200-wide tile, two column tiles
D_CASES = [256, 200]
STEP = tss.STEP_K


def frames_np(seed, n, H, W):
    return np.random.default_rng(seed).uniform(0, 1.5, (n, H, W)).astype(
        np.float32)


def tiles_both(seed, D, H, W, h, w, stride, streams=None):
    C, B0, b = model_arrays(seed, D, h)
    jg = jss.precompute_geometry(jnp.asarray(B0), jnp.asarray(b), W=W, w=w,
                                 stride=stride, block_d=BLOCK_D)
    tg = tss.precompute_geometry(t(B0), t(b), W=W, w=w, stride=stride,
                                 block_d=BLOCK_D)
    if streams is None:
        return (jss.retile_classes(jg, jnp.asarray(C)),
                tss.retile_classes(tg, t(C)))
    Cs = np.random.default_rng(seed + 1).standard_normal(
        (streams, 2, D)).astype(np.float32)
    return (jss.retile_classes_fleet(jg, jnp.asarray(Cs)),
            tss.retile_classes_fleet(tg, t(Cs)))


# ---------------------------------------------------------------------------
# (a) the reuse GEMMs, the 3xTF32 steps and the window close
# ---------------------------------------------------------------------------

def tf32_rna(a):
    """float32 -> TF32 bits, nearest with ties away from zero (the bits of
    ``cvt.rna.tf32.f32``, as ``encode_common.cuh::tf32_rna`` writes it)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def step_partial(A, B):
    """One 32-deep K step: the three TF32 products of each split operand
    pair, exact, summed (in float64, standing in for the tensor cores'
    accumulate) and rounded once to float32."""
    Ab, Bb = tf32_rna(A), tf32_rna(B)
    As, Bs = tf32_rna(A - Ab), tf32_rna(B - Bb)
    d = torch.float64
    return (Ab.to(d) @ Bs.to(d) + As.to(d) @ Bb.to(d)
            + Ab.to(d) @ Bb.to(d)).float()


def block_operands(frames, slabs, h, stride, g, q, dt, j0):
    """``A_q (N*my, Kp)`` and ``B_q (Kp, COL_TILE)`` of frame-column block
    ``q`` for the column tile at ``j0`` of D-tile ``dt``; depth ``(r, c)``
    flattened as ``r*g + c`` and zero-padded to ``Kp``, a multiple of the
    K step; B past the slab row's end reads 0."""
    N, H, W = frames.shape
    my = (H - h) // stride + 1
    L = slabs.shape[-1]
    kd = h * g
    kp = -(-kd // STEP) * STEP
    rows = (torch.arange(my)[:, None] * stride + torch.arange(h)[None, :])
    A = frames[:, rows, q * g:(q + 1) * g].reshape(N * my, kd)
    A = torch.nn.functional.pad(A, (0, kp - kd))
    idx = (q * g + torch.arange(g)[:, None] + j0
           + torch.arange(tss.COL_TILE)[None, :])            # (g, COL_TILE)
    B = torch.where(idx < L, slabs[dt][:, idx.clamp(max=L - 1)], 0.0)
    B = torch.nn.functional.pad(B.reshape(kd, tss.COL_TILE),
                                (0, 0, 0, kp - kd))
    return A, B


def window_groups(mx, stride, w, g):
    """Per block of windows: ``(kx0, [(start, end)] in blocks of g)``."""
    out = []
    for kx0 in range(0, mx, tss.WINDOWS_PER_BLOCK):
        kxs = range(kx0, min(mx, kx0 + tss.WINDOWS_PER_BLOCK))
        out.append((kx0, [(kx * stride // g, kx * stride // g + w // g)
                          for kx in kxs]))
    return out


def emulated_window_acc(frames, slabs, h, w, stride, td, form="prefix"):
    """The kernel's float32 window sums ``(N, my, mx, n_dt, td)``.

    ``form="prefix"`` (the kernel's): one running sum ``P`` over the
    group's blocks, a window ``P[end] - P[start]``; ``"sliding"``: each
    block's own sum ``Q_q``, added into every window that holds it."""
    N, H, W = frames.shape
    my, mx = (H - h) // stride + 1, (W - w) // stride + 1
    g = math.gcd(stride, w)
    n_dt = slabs.shape[0]
    out = torch.zeros((N * my, mx, n_dt, td))
    for dt in range(n_dt):
        for j0 in range(0, td, tss.COL_TILE):
            n = min(tss.COL_TILE, td - j0)
            for kx0, wins in window_groups(mx, stride, w, g):
                P = torch.zeros((N * my, tss.COL_TILE))
                opened, sums = {}, {}
                for q in range(wins[0][0], wins[-1][1]):
                    A, B = block_operands(frames, slabs, h, stride, g, q, dt,
                                          j0)
                    Q = torch.zeros_like(P)
                    for k0 in range(0, A.shape[1], STEP):
                        part = step_partial(A[:, k0:k0 + STEP],
                                            B[k0:k0 + STEP])
                        if form == "prefix":
                            P = P + part
                        else:
                            Q = Q + part
                    for i, (start, end) in enumerate(wins):
                        if form == "sliding" and start <= q < end:
                            sums[i] = Q if q == start else sums[i] + Q
                        if end == q + 1:
                            acc = P - opened[i] if i else P
                            if form == "sliding":
                                acc = sums[i]
                            out[:, kx0 + i, dt, j0:j0 + n] = acc[:, :n]
                        if i and start == q + 1:
                            opened[i] = P
    return out.reshape(N, my, mx, n_dt, td)


def exact_window_acc(frames, slabs, h, w, stride, td):
    """The window sums in float64, straight from the definition."""
    N, H, W = frames.shape
    my, mx = (H - h) // stride + 1, (W - w) // stride + 1
    n_dt = slabs.shape[0]
    f, s = frames.double(), slabs.double()
    out = torch.zeros((N, my, mx, n_dt, td), dtype=torch.float64)
    for ky in range(my):
        for kx in range(mx):
            x = f[:, ky * stride:ky * stride + h, kx * stride:
                  kx * stride + w]                            # (N, h, w)
            for dt in range(n_dt):
                win = s[dt][:, kx * stride:kx * stride + w + td - 1]
                B = win.unfold(-1, td, 1)                     # (h, w, td)
                out[:, ky, kx, dt] = torch.einsum("nrc,rcj->nj", x, B)
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_reuse_gemms_equal_the_window_sums(shape):
    """Both window closes of the reuse GEMMs against the float64 window
    sums: each pixel of a row band meets each base row once per block."""
    H, W, h, w, stride = shape
    _, tt = tiles_both(31, 200, H, W, h, w, stride)
    fr = t(frames_np(32, 2, H, W))
    exact = exact_window_acc(fr, tt.slabs, h, w, stride, tt.block_d)
    for form in ("prefix", "sliding"):
        got = emulated_window_acc(fr, tt.slabs, h, w, stride, tt.block_d,
                                  form)
        err = float((got.double() - exact).abs().max())
        assert err <= 2e-5 * float(exact.abs().max()), (form, err)


def test_prefix_close_error_at_the_paper_depth():
    """The two window closes at the paper's 96 x 96 windows, stride 8
    over 128-wide frames (g = 8, 16 blocks of depth 768, five windows of
    12 blocks in one group): once divided by the window norm, both errors
    are far inside the score tolerance. The prefix form's is the larger
    (it keeps one running sum and a start value per open window, where
    the sliding form keeps a sum per window), but it lets one block hold
    all five windows in shared memory; the kernel takes it."""
    H = W = 128
    h = w = 96
    stride = 8
    _, B0, b = model_arrays(33, 128, h)
    geom = tss.precompute_geometry(t(B0), t(b), W=W, w=w, stride=stride,
                                   block_d=128)
    fr = t(frames_np(34, 1, 96 + 8, W))                     # my = 2
    exact = exact_window_acc(fr, geom.slabs, h, w, stride, 128)
    norms = tss.window_norms_batch(fr, h, w, stride)[..., None, None]
    errs = {}
    for form in ("prefix", "sliding"):
        got = emulated_window_acc(fr, geom.slabs, h, w, stride, 128, form)
        errs[form] = float(((got.double() - exact) / norms).abs().max())
    assert max(errs.values()) < SCORE_ATOL / 20, errs


# ---------------------------------------------------------------------------
# (b) the window norms, the epilogue's column partition and the fold
# ---------------------------------------------------------------------------

def window_norms_direct(frames, h, w, stride):
    """The kernel's window norms: each window's sum of squared pixels in
    float32 (no summed-area table), ``sqrt(max(sum, 1e-16))``."""
    win = frames.unfold(1, h, stride).unfold(2, w, stride)   # (N,my,mx,h,w)
    return torch.sqrt(torch.clamp((win * win).sum((-2, -1)), min=1e-16))


def emulated_scores(frames, tiles, h, w, stride, nonlinearity="rff",
                    frames_per_stream=None):
    """The kernel's scores: window sums as in (a), ``acc / max(norm,
    1e-8)``, the nonlinearity, the partitioned classifier partials and the
    cosine epilogue with the stream's class norms."""
    N = frames.shape[0]
    acc = emulated_window_acc(frames, tiles.slabs, h, w, stride,
                              tiles.block_d)              # (N,my,mx,n_dt,td)
    norms = window_norms_direct(frames, h, w, stride)
    s_n = acc / torch.clamp(norms, min=1e-8)[..., None, None]
    phi = apply_nonlinearity(s_n, tiles.bias_t.permute(1, 0, 2),
                             nonlinearity)
    per_stream = tiles.cpos_t.ndim == 4
    C = frames_per_stream if per_stream else N

    def classes(c):                       # broadcast to (N, my, mx, n_dt, td)
        if not per_stream:
            return c.permute(1, 0, 2)
        return torch.repeat_interleave(c.permute(0, 2, 1, 3), C, dim=0)[
            :, None]

    dp = partition_sum(phi * classes(tiles.cpos_t))
    dn = partition_sum(phi * classes(tiles.cneg_t))
    qq = partition_sum(phi * phi)
    cpn, cnn = tiles.cpos_norm, tiles.cneg_norm
    if per_stream:
        cpn = torch.repeat_interleave(cpn, C)[:, None, None]
        cnn = torch.repeat_interleave(cnn, C)[:, None, None]
    qn = torch.clamp(torch.sqrt(qq), min=1e-9)
    return (dp / (qn * torch.clamp(cpn, min=1e-9))
            - dn / (qn * torch.clamp(cnn, min=1e-9)))


@pytest.mark.parametrize("nonlinearity", ["rff", "linear", "sign"])
@pytest.mark.parametrize("D", D_CASES)
def test_emulated_scores_match_jax(D, nonlinearity):
    H, W, h, w, stride = SHAPES[0]
    jt, tt = tiles_both(35, D, H, W, h, w, stride)
    fr = frames_np(36, 3, H, W)
    got = emulated_scores(t(fr), tt, h, w, stride, nonlinearity)
    want = jss.fragment_scores_batch(jnp.asarray(fr), jt,
                                     nonlinearity=nonlinearity,
                                     interpret=True, h=h, w=w, stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SCORE_ATOL)
    # the partition and the window groups depend on (W, w, stride, td)
    # alone: frame 1 alone is bitwise the frame inside the batch
    alone = emulated_scores(t(fr[1:2]), tt, h, w, stride, nonlinearity)
    assert torch.equal(alone[0], got[1])


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_emulated_scores_ragged_per_stream(shape):
    """Odd strides (g = 3, 1), W not a multiple of 4, a ragged depth,
    two D-tiles and per-stream classes (2 streams x 2 frames)."""
    H, W, h, w, stride = shape
    jt, tt = tiles_both(37, 256, H, W, h, w, stride, streams=2)
    fr = frames_np(38, 4, H, W)
    got = emulated_scores(t(fr), tt, h, w, stride, frames_per_stream=2)
    want = jss.fragment_scores_batch(jnp.asarray(fr), jt, interpret=True,
                                     frames_per_stream=2, h=h, w=w,
                                     stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SCORE_ATOL)
    torch.testing.assert_close(
        got, tss.fragment_scores_batch(t(fr), tt, h=h, w=w, stride=stride,
                                       frames_per_stream=2),
        rtol=0, atol=SCORE_ATOL)


def test_block_is_one_size_at_any_width():
    """The Python mirror of the block: a 64 x 128 tile of five windows
    whose shared memory no frame, window or tile width changes (also
    checked against the CUDA export on the card by ``chip_smoke.py``);
    the paper's frame and a 1024-wide one, past the CUDA-core kernel's
    limit, both walk their windows in groups of at most five."""
    assert (tss.ROW_TILE, tss.COL_TILE, tss.WINDOWS_PER_BLOCK) == (64, 128, 5)
    for W, w, stride, groups in ((128, 96, 8, 1), (1024, 8, 8, 26)):
        mx = (W - w) // stride + 1
        walk = window_groups(mx, stride, w, math.gcd(stride, w))
        assert len(walk) == groups
        assert [len(wins) for _, wins in walk] == [5] * (mx // 5) + (
            [mx % 5] if mx % 5 else [])
    assert tss.smem_bytes() == 4 * (3 * (64 * 36 + 32 * 132 + 128 + 32)
                                    + 4 * 32 * 256 + 4 * 64 * 3) == 214_400
    assert tss.smem_bytes() < tss.SMEM_LIMIT_BYTES == 232_448
