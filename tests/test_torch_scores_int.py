"""PyTorch port, the int scorer's tensor-core design emulated on the CPU and
held against the JAX package.

``csrc/sliding_scores_int.cu`` runs only on the card, so these tests
replay its index maps and its float epilogue in plain PyTorch: (a) the GEMM
``A (M, K) @ B (K, td)`` with A the im2col of the codes over a depth padded
to groups of 4, B the Hankel view of the int8 slabs read as the kernel
reads it (two aligned words joined by a funnel shift), and codes wider
than 8 bits summed by Horner over
their bytes with wrapping int32 arithmetic, bitwise equal to the JAX
``_int_window_acc``; (b) the kernel's column partition (``COL_TILE``
columns per partial, summed per thread, across a quad, then across the
warps) and the left-to-right fold, in float32, within ``SCORE_ATOL`` of
the JAX scores and bitwise the same for a frame alone and inside a batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SCORE_ATOL, model_arrays, partition_sum, t
from repro.kernels import sliding_scores_int as jssi
from repro_torch.kernels import sliding_scores_int as tssi

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

#: ragged shapes (H, W, h, w, stride): odd strides, W not a multiple of 4,
#: w % 4 != 0 (padded groups), K steps of 64 that straddle 8 base rows
#: (w = 7, 8 with padding) or two (w = 37, 40 with padding)
SHAPES = [(23, 23, 7, 7, 3), (40, 45, 5, 37, 5)]
#: (geometry mode, ADC bits) of each precision; 4-bit codes unpacked
PRECISIONS = {"int8": ("int8", 8), "int4": ("int8", 4),
              "binary": ("binary", 8), "u10": ("int8", 10)}
BLOCK_D = 128
#: 256 -> two 128-wide tiles; 200 -> one 200-wide tile, two column tiles
D_CASES = [256, 200]


def codes_np(seed, n, H, W, bits):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, (n, H, W)).astype(
        np.uint8 if bits <= 8 else np.uint16)


def geometries(seed, D, H, W, h, w, stride, mode):
    C, B0, b = model_arrays(seed, D, h)
    jt = jssi.precompute_tiles_int(jnp.asarray(B0), jnp.asarray(b),
                                   jnp.asarray(C), W=W, w=w, stride=stride,
                                   block_d=BLOCK_D, mode=mode)
    tt = tssi.precompute_tiles_int(t(B0), t(b), t(C), W=W, w=w,
                                   stride=stride, block_d=BLOCK_D, mode=mode)
    return jt, tt


# ---------------------------------------------------------------------------
# (a) the kernel's index maps
# ---------------------------------------------------------------------------

def _funnel(lo, hi, shift):
    """``__funnelshift_r(lo, hi, shift)`` on uint32 tensors (int64)."""
    return ((hi << 32 | lo) >> shift) & 0xFFFFFFFF


def _b_operand(slabs_q, h, w, dt, x0, j0):
    """The B registers of one column tile as the kernel reads them:
    ``(K4 / 4, COL_TILE)`` words, group ``k / 4`` at column ``c`` holding
    ``B[k .. k+3, j0 + c]`` for the windows that start at pixel ``x0 =
    kx * stride``. Group ``k`` (base row ``r = k // w4``, position ``i``)
    starts at slab byte ``src``; the kernel stages the window from
    ``src & ~15`` (zero past the slabs' end) and reads byte offset
    ``o = (src & 15) + c`` as two words joined by a funnel shift."""
    n_dt, _, L = slabs_q.shape
    w4 = -(-w // 4) * 4
    flat = slabs_q.reshape(-1).view(torch.uint8).to(torch.int64)
    n_words = -(-flat.numel() // 4) + 40
    pad = torch.zeros(4 * n_words, dtype=torch.int64)
    pad[:flat.numel()] = flat
    words = (pad[0::4] | pad[1::4] << 8 | pad[2::4] << 16 | pad[3::4] << 24)
    k = torch.arange(0, h * w4, 4)
    r = k // w4
    src = (dt * h + r) * L + x0 + j0 + (k - r * w4)              # (groups,)
    sh = (src & 15)[:, None]
    base = (src >> 4)[:, None] * 4                                # word index
    c = torch.arange(tssi.COL_TILE)[None, :]
    o = sh + c
    lo, hi = words[base + (o >> 2)], words[base + (o >> 2) + 1]
    # per warp the byte offset o & 3 is the same for every n8 tile
    return _funnel(lo, hi, 8 * (o & 3))


def _bytes_s8(word_regs):
    """(groups, cols) words -> (4 * groups, cols) signed bytes, k-major."""
    b = torch.stack([(word_regs >> (8 * e)) & 0xFF for e in range(4)], 1)
    b = torch.where(b >= 128, b - 256, b)
    return b.reshape(-1, word_regs.shape[1])


def _a_operand(codes, h, w, stride, byte):
    """``(N * my, mx, K4)`` im2col of byte ``byte`` of the codes: rows
    (n, ky) of each fragment column kx, depth (r, i) with i over w rounded
    up to 4 (code 0 past w)."""
    N, H, W = codes.shape
    w4 = -(-w // 4) * 4
    my, mx = (H - h) // stride + 1, (W - w) // stride + 1
    c = (codes.to(torch.int64) >> (8 * byte)) & 0xFF
    c = torch.nn.functional.pad(c, (0, w4 - w))
    win = c.unfold(1, h, stride).unfold(2, w4, stride)[:, :my, :mx]
    # win: (N, my, mx, h, w4); columns i >= w of each window read 0
    keep = torch.arange(w4) < w
    return (win * keep).reshape(N * my, mx, h * w4)


def emulated_window_acc(codes, slabs_q, h, w, stride, td):
    """The kernel's int32 sums ``(N, my, n_dt, mx, td)``: per D-tile,
    fragment column and column tile one GEMM of A against the B registers,
    byte passes from the highest down, ``acc = acc * 256 + pass`` wrapping
    at 32 bits."""
    N, H, W = codes.shape
    my, mx = (H - h) // stride + 1, (W - w) // stride + 1
    n_dt = slabs_q.shape[0]
    passes = 1 if codes.dtype == torch.uint8 else 2
    A = [_a_operand(codes, h, w, stride, byte) for byte in range(passes)]
    out = torch.zeros((N * my, n_dt, mx, td), dtype=torch.int64)
    for dt in range(n_dt):
        for kx in range(mx):
            for j0 in range(0, td, tssi.COL_TILE):
                B = _bytes_s8(_b_operand(slabs_q, h, w, dt, kx * stride, j0))
                acc = torch.zeros((N * my, tssi.COL_TILE), dtype=torch.int64)
                for byte in reversed(range(passes)):
                    acc = acc * 256 + A[byte][:, kx] @ B
                    acc = (acc + 2**31) % 2**32 - 2**31           # wrap
                n = min(tssi.COL_TILE, td - j0)
                out[:, dt, kx, j0:j0 + n] = acc[:, :n]
    return out.to(torch.int32).reshape(N, my, n_dt, mx, td)


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_gemm_sums_bitwise(shape, precision):
    H, W, h, w, stride = shape
    mode, bits = PRECISIONS[precision]
    jt, tt = geometries(21, 200, H, W, h, w, stride, mode)
    codes = codes_np(22, 2, H, W, bits)
    n_dt, td = tt.geom.slabs_q.shape[0], tt.geom.block_d
    got = emulated_window_acc(t(codes), tt.geom.slabs_q, h, w, stride, td)
    np.testing.assert_array_equal(
        got.numpy(),
        tssi.int_window_acc(t(codes), tt.geom, h=h, w=w,
                            stride=stride).numpy())
    my = (H - h) // stride + 1
    for n in range(2):
        for ky in range(my):
            block = jnp.asarray(codes[n, ky * stride: ky * stride + h]
                                .astype(np.int32))
            for dt in range(n_dt):
                np.testing.assert_array_equal(
                    got[n, ky, dt].numpy(),
                    np.asarray(jssi._int_window_acc(
                        block, jt.geom.slabs_q[dt], jt.geom.win_mask, h=h,
                        W=W, td=td)))


def test_horner_wraps_like_int32():
    """Byte passes into one wrapping accumulator equal the wrapped true sum
    even where it overflows int32 (the contract keeps real sums inside):
    16-bit codes near full scale against slab values near +127 over
    18 x 20 windows."""
    rng = np.random.default_rng(23)
    codes = torch.from_numpy(rng.integers(60000, 1 << 16, (3, 20, 32))
                             .astype(np.uint16))
    slabs = torch.from_numpy(rng.integers(100, 128, (1, 18, 40 + 32 - 1))
                             .astype(np.int8))
    got = emulated_window_acc(codes, slabs, 18, 20, 6, 40)
    A = (_a_operand(codes, 18, 20, 6, 0)
         + 256 * _a_operand(codes, 18, 20, 6, 1))
    B = _bytes_s8(_b_operand(slabs, 18, 20, 0, 6, 0))[:, :40]
    true = A[:, 1] @ B                           # kx = 1: windows at pixel 6
    assert true.min() > 2**31                    # the case wraps
    want = ((true + 2**31) % 2**32 - 2**31).to(torch.int32)
    assert torch.equal(got[:, 0, 0, 1].reshape(-1, 40), want)


# ---------------------------------------------------------------------------
# (b) the column partition and the fold
# ---------------------------------------------------------------------------

def emulated_scores(acc, tiles, h, w, stride, codes, nonlinearity="rff"):
    """The kernel's epilogue in float32: the nonlinearity, then the column
    partition and the fold (``partition_sum``)."""
    from repro_torch.core.encoding import apply_nonlinearity
    geom = tiles.geom
    norms = tssi._scaled_norms(codes, geom, h, w, stride)       # (N, my, mx)
    s_n = acc.permute(0, 1, 3, 2, 4).to(torch.float32) / norms[..., None, None]
    phi = apply_nonlinearity(s_n, geom.bias_t.permute(1, 0, 2), nonlinearity)
    prods = [phi * tiles.cpos_t.permute(1, 0, 2).to(torch.float32),
             phi * tiles.cneg_t.permute(1, 0, 2).to(torch.float32), phi * phi]
    dp, dn, qq = (partition_sum(x) for x in prods)     # x: (N,my,mx,n_dt,td)
    qn = torch.clamp(torch.sqrt(qq), min=1e-9)
    return (dp / (qn * torch.clamp(tiles.cpos_norm, min=1e-9))
            - dn / (qn * torch.clamp(tiles.cneg_norm, min=1e-9)))


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("D", D_CASES)
def test_emulated_partition_scores_match_jax(D, precision):
    H, W, h, w, stride = SHAPES[1]
    mode, bits = PRECISIONS[precision]
    jt, tt = geometries(24, D, H, W, h, w, stride, mode)
    codes = codes_np(25, 7, H, W, bits)
    acc = emulated_window_acc(t(codes), tt.geom.slabs_q, h, w, stride,
                              tt.geom.block_d)
    got = emulated_scores(acc, tt, h, w, stride, t(codes))
    want = jssi.fragment_scores_batch_int_ref(
        jnp.asarray(codes.astype(np.int32)), jt, h=h, w=w, stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SCORE_ATOL)
    # the partition depends on td alone: frame 3 alone (N = 1) is bitwise
    # the frame inside the 7-frame batch
    alone = emulated_scores(acc[3:4], tt, h, w, stride, t(codes[3:4]))
    assert torch.equal(alone[0], got[3])


def test_block_sizes_mirror_the_kernel():
    """The Python mirror of the block: column tile, row tile and shared
    memory, fixed whatever the frame (the column tile and shared memory
    also checked against the CUDA exports on the card by
    ``chip_smoke.py``)."""
    assert (tssi.COL_TILE, tssi.ROW_TILE) == (128, 64)
    assert tssi.smem_bytes() == 4 * (64 * 80 + 4 * 16 * 40 + 64) <= 48 * 1024
    for args in [(8, 32, 32, 8, 8), (4, 128, 128, 96, 96),
                 (1, 8, 4096, 8, 8)]:
        b = tssi.int_datapath_bounds(*args, stride=8)
        assert b["smem_bytes"] == tssi.smem_bytes() < b["smem_limit_bytes"]
