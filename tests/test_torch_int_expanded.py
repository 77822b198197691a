"""PyTorch port, the expanded-slab int scorer held against the reference's
twin in ``benchmarks/int_datapath.py`` (``_expand_slabs``,
``_expanded_scores``, run in Pallas interpret mode as the script runs it)
and against the port's live int scorer.

``csrc/int_expanded.cu`` runs only on the card (``chip_smoke.py`` holds it
against :func:`expanded_scores_plain` there); on the CPU the wrapper runs
the plain version, which these tests hold: the expanded operand bitwise,
the scores within ``SCORE_ATOL``, the exact int32 window sums bitwise equal
to the live scorer's ``int_window_acc``.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SCORE_ATOL, model_arrays, t
from repro.kernels import sliding_scores_int as jssi
from repro_torch.kernels import int_expanded as tie
from repro_torch.kernels import sliding_scores_int as tssi

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _bench():
    """``benchmarks/int_datapath.py`` loaded from its path (whatever the
    working directory)."""
    spec = importlib.util.spec_from_file_location(
        "int_datapath_bench", ROOT / "benchmarks" / "int_datapath.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _bench()


#: (N, H, W, h, w, stride, D, block_d): strides 2 and 4, one and two
#: D-tiles (D = 128 at block_d 128; D = 256 at 128), N of 1 and 5, and a
#: frame wider than high
CASES = [(1, 16, 16, 4, 4, 4, 128, 128), (5, 16, 16, 4, 4, 2, 256, 128),
         (5, 12, 20, 4, 6, 2, 128, 128), (1, 16, 16, 4, 4, 2, 256, 128)]


def _setup(case, seed=0, bits=8):
    N, H, W, h, w, stride, D, block_d = case
    C, B0, b = model_arrays(seed, D, h)
    rng = np.random.default_rng(seed + 100)
    codes = rng.integers(0, 1 << bits, (N, H, W)).astype(np.uint8)
    jt = jssi.precompute_tiles_int(jnp.asarray(B0), jnp.asarray(b),
                                   jnp.asarray(C), W=W, w=w, stride=stride,
                                   block_d=block_d)
    tt = tssi.precompute_tiles_int(t(B0), t(b), t(C), W=W, w=w,
                                   stride=stride, block_d=block_d)
    return codes, jt, tt


@pytest.mark.parametrize("case", CASES)
def test_expand_slabs_bitwise(bench, case):
    codes, jt, tt = _setup(case)
    W = case[2]
    want = np.asarray(bench._expand_slabs(jt.geom, W))
    got = tie.expand_slabs(tt.geom, W)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numel() == tie.expanded_bytes(case[3], W, case[6], case[7])


@pytest.mark.parametrize("case", CASES)
def test_scores_match_reference_twin(bench, case):
    N, H, W, h, w, stride, D, block_d = case
    codes, jt, tt = _setup(case)
    want = np.asarray(bench._expanded_scores(
        jnp.asarray(codes), bench._expand_slabs(jt.geom, W), jt, h=h, w=w,
        stride=stride))
    E = tie.expand_slabs(tt.geom, W)
    got = tie.expanded_scores(t(codes), E, tt, h=h, w=w, stride=stride)
    plain = tie.expanded_scores_plain(t(codes), E, tt, h=h, w=w,
                                      stride=stride)
    my, mx = (H - h) // stride + 1, (W - w) // stride + 1
    assert got.shape == (N, my, mx) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_ATOL)
    # on the CPU the wrapper is the plain version, and it adds no launch
    assert torch.equal(got, plain)
    # the live int scorer computes the same function
    live = tssi.fragment_scores_batch_int(t(codes), tt, h=h, w=w,
                                          stride=stride)
    np.testing.assert_allclose(got.numpy(), live.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
def test_window_acc_bitwise_vs_live(case, dtype):
    N, H, W, h, w, stride, D, block_d = case
    codes, _, tt = _setup(case)
    codes = t(codes).to(dtype)
    E = tie.expand_slabs(tt.geom, W)
    got = tie.expanded_window_acc(codes, E, tt.geom, h=h, w=w, stride=stride)
    want = tssi.int_window_acc(codes, tt.geom, h=h, w=w, stride=stride)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def test_window_acc_bitwise_vs_reference_at_12_bits():
    """uint16 codes (12-bit ADC): the sums stay exact and equal the JAX
    ``_int_window_acc`` of the live layout."""
    case = (2, 16, 16, 4, 4, 2, 128, 128)
    N, H, W, h, w, stride, D, block_d = case
    _, jt, tt = _setup(case)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 1 << 12, (N, H, W)).astype(np.uint16)
    E = tie.expand_slabs(tt.geom, W)
    got = tie.expanded_window_acc(t(codes).to(torch.int32), E, tt.geom, h=h,
                                  w=w, stride=stride)
    my = (H - h) // stride + 1
    jc = jnp.asarray(codes.astype(np.int32))
    want = np.stack([np.stack([np.stack([np.asarray(jssi._int_window_acc(
        jc[n, ky * stride:ky * stride + h], jt.geom.slabs_q[dt],
        jt.geom.win_mask, h=h, W=W, td=jt.geom.block_d))
        for dt in range(jt.geom.slabs_q.shape[0])])
        for ky in range(my)]) for n in range(N)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_refuses_what_the_reference_twin_does_not_take():
    case = (4, 16, 16, 4, 4, 4, 128, 128)
    N, H, W, h, w, stride, D, block_d = case
    codes, _, tt = _setup(case)
    E = tie.expand_slabs(tt.geom, W)
    kw = dict(h=h, w=w, stride=stride)
    # per-stream class tiles
    C = np.random.default_rng(3).standard_normal((2, 2, D)).astype(
        np.float32)
    fleet = tssi.retile_classes_int_fleet(tt.geom, t(C))
    with pytest.raises(ValueError, match="single-model"):
        tie.expanded_scores(t(codes), E, fleet, **kw)
    # a non-RFF nonlinearity
    for nl in ("linear", "sign"):
        with pytest.raises(ValueError, match="RFF"):
            tie.expanded_scores(t(codes), E, tt, nonlinearity=nl, **kw)
    # float frames, an operand of another width, a misfit geometry
    with pytest.raises(TypeError, match="integer"):
        tie.expanded_scores(t(codes).float(), E, tt, **kw)
    with pytest.raises(ValueError, match="expanded operand"):
        tie.expanded_scores(t(codes), E[:, :-1], tt, **kw)
    with pytest.raises(ValueError):
        tie.expand_slabs(tt.geom, W + 1)
    with pytest.raises(ValueError):
        tie.expanded_scores(t(codes)[:, :, :-2], E, tt, **kw)


def test_expanded_bytes_grow_linearly_in_W():
    # the deployment geometry the reference names: 16x16 windows over
    # 4096-wide frames; one D-wide tile at D = 5000, 512-wide ones at 5120
    assert tie.expanded_bytes(16, 4096, 5000, 512) == 16 * 4096 * 5000
    assert tie.expanded_bytes(16, 4096, 5120, 512) == 16 * 4096 * 5120
    assert tie.expanded_bytes(96, 128, 5000, 512) == 61_440_000
    assert (tie.expanded_bytes(16, 8192, 5000)
            == 2 * tie.expanded_bytes(16, 4096, 5000))
    # ... where the live kernel's block is the same at any width
    a = tssi.int_datapath_bounds(4, 128, 4096, 16, 16, stride=16)
    b = tssi.int_datapath_bounds(4, 128, 512, 16, 16, stride=16)
    assert a["smem_bytes"] == b["smem_bytes"] < 48 * 1024


# ---------------------------------------------------------------------------
# the CUDA kernel's walk, emulated on the CPU
# ---------------------------------------------------------------------------

M32 = (1 << 32) - 1


def emulated_kernel_acc(codes, E, h, w, stride, stats=None):
    """``csrc/int_expanded.cu``'s window sums, vectorized over (frame, row
    band) rows and (D-tile, column) columns: K walked in column blocks
    between consecutive window points ``{kx*s} ∪ {kx*s + w}``; per block,
    one byte pass per byte of the codes (1 for uint8, 2 for uint16, 4 for
    wider codes, highest first), the block accumulator ``T`` shifted left
    by 8 before each pass but the first; a pass in steps of 16 groups of 4
    consecutive ``i`` of one base row ``r``, r-major (codes at or past the
    block's end read 0, groups past ``h * ceil(wb / 4)`` are empty), each
    step one product of its 64 k; then ``P += T``. At a point, a window
    that closes takes ``P - ring[kx % slots]``, then a window that opens
    stores ``ring[kx % slots] = P``, with ``slots = min(mx, ceil(w / s))``.
    All modulo 2^32 (the kernel's wrapping adds), read back as int32.

    The walk checks itself as it goes: each pass of a block covers every
    ``(r, i)`` of the block once, and a window that closes finds its own
    snapshot in its slot. ``stats``, where given, receives the K steps it
    took over every pass and the ring's slots."""
    N, H, W = codes.shape
    n_dt, _, td = E.shape
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    passes = {torch.uint8: 1, torch.uint16: 2}.get(codes.dtype, 4)
    slots = min(mx, -(-w // stride))
    Er = E.reshape(n_dt, h, W, td).to(torch.int64)
    ky = torch.arange(my) * stride
    band = codes.to(torch.int64)[:, ky[:, None] + torch.arange(h)[None, :]]
    band = (band & M32).reshape(N * my, h, W)          # (rows, h, W)
    P = torch.zeros((N * my, n_dt * td), dtype=torch.int64)
    ring = torch.zeros((slots,) + P.shape, dtype=torch.int64)
    tag = [None] * slots                    # whose snapshot a slot holds
    steps = 0
    out = torch.zeros((N, my, n_dt, mx, td), dtype=torch.int64)
    points = sorted({kx * stride for kx in range(mx)}
                    | {kx * stride + w for kx in range(mx)})
    for c0, c1 in zip(points, points[1:] + [None]):
        if (c0 - w) % stride == 0 and 0 <= (c0 - w) // stride < mx:
            kx = (c0 - w) // stride                    # closes at c0
            assert tag[kx % slots] == kx, "a slot was reused while open"
            acc = (P - ring[kx % slots]) & M32
            out[:, :, :, kx] = acc.reshape(N, my, n_dt, td)
        if c0 % stride == 0 and c0 // stride < mx:     # opens at c0
            ring[(c0 // stride) % slots] = P
            tag[(c0 // stride) % slots] = c0 // stride
        if c1 is None:
            break
        gpr = -(-(c1 - c0) // 4)
        n_steps = -(-h * gpr // 16)
        T = torch.zeros_like(P)
        for byte in reversed(range(passes)):
            T = (T << 8) & M32
            seen = torch.zeros((h, c1 - c0), dtype=torch.int64)
            for st in range(n_steps):
                gg = torch.arange(16 * st, 16 * st + 16)
                r = (gg // gpr).repeat_interleave(4)
                i = (c0 + 4 * (gg % gpr)).repeat_interleave(4) \
                    + torch.arange(4).repeat(16)
                ok = (r < h) & (i < c1)
                rc, ic = r.clamp(max=h - 1), i.clamp(max=W - 1)
                seen.index_put_((rc[ok], ic[ok] - c0),
                                torch.ones(int(ok.sum()), dtype=torch.int64),
                                accumulate=True)
                A = (band[:, rc, ic] >> (8 * byte)) & 0xFF  # (rows, 64)
                B = Er[:, rc, ic].permute(1, 0, 2).reshape(64, n_dt * td)
                T = (T + (A * ok) @ (B * ok[:, None])) & M32
            assert (seen == 1).all(), "a pass missed or repeated a k"
            steps += n_steps
        P = (P + T) & M32
    if stats is not None:
        stats.update(steps=steps, slots=slots)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


#: the walk's cases beyond CASES: s not dividing w with s % 4 != 0 and h
#: % 32 != 0; td off the 128-column tile with two D-tiles (td 150 of
#: D 300); h = 33 over 40-wide frames; a 64-column block between the
#: window points (w = 16 at stride 4)
WALK_CASES = CASES + [(2, 12, 23, 3, 7, 3, 128, 128),
                      (3, 13, 22, 5, 7, 3, 300, 150),
                      (2, 40, 40, 33, 9, 5, 200, 512),
                      (2, 20, 28, 16, 16, 4, 256, 128)]


@pytest.mark.parametrize("case", WALK_CASES)
def test_emulated_kernel_walk_bitwise(case):
    N, H, W, h, w, stride, D, block_d = case
    codes, _, tt = _setup(case)
    E = tie.expand_slabs(tt.geom, W)
    got = emulated_kernel_acc(t(codes), E, h, w, stride)
    want = tssi.int_window_acc(t(codes), tt.geom, h=h, w=w, stride=stride)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", WALK_CASES[-4:])
@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
def test_emulated_kernel_walk_bitwise_wide_codes(case, dtype):
    """12-bit codes in uint16 (two byte passes) and int32 (four): Horner
    over the bytes gives the live scorer's sums bit for bit."""
    N, H, W, h, w, stride, D, block_d = case
    _, _, tt = _setup(case)
    codes = np.random.default_rng(5).integers(0, 1 << 12, (N, H, W))
    codes = t(codes.astype(np.int32)).to(dtype)
    E = tie.expand_slabs(tt.geom, W)
    got = emulated_kernel_acc(codes, E, h, w, stride)
    want = tssi.int_window_acc(codes.to(torch.int32), tt.geom, h=h, w=w,
                               stride=stride)
    assert torch.equal(got, want)


def test_emulated_kernel_walk_wraps_like_int32():
    """Window sums past int32 (outside the bounds contract) wrap the same
    way in the kernel's prefix-difference form as in a direct int32 sum:
    the unsigned adds are exact modulo 2^32."""
    h, w, stride, W, td = 2, 4, 2, 8, 4
    codes = torch.full((1, h, W), 2**30, dtype=torch.int64)
    E = torch.full((1, h * W, td), 3, dtype=torch.int8)
    got = emulated_kernel_acc(codes, E, h, w, stride)
    direct = (torch.tensor(2**30 * 3 * h * w, dtype=torch.int64)
              & ((1 << 32) - 1))
    direct = direct - (1 << 32) if direct >= 1 << 31 else direct
    assert (got == int(direct)).all()


def _open_most(W, w, stride):
    """The most windows open at once over a row of ``W`` columns."""
    mx = (W - w) // stride + 1
    return max(sum(kx * stride <= c < kx * stride + w for kx in range(mx))
               for c in range(W))


@pytest.mark.parametrize("case", WALK_CASES)
def test_emulated_walk_ring_and_steps(case):
    """The walk's ring holds exactly the windows open at once (each close
    finds its snapshot), every pass covers its block once, and a byte pass
    more takes as many K steps again."""
    N, H, W, h, w, stride, D, block_d = case
    codes, _, tt = _setup(case)
    E = tie.expand_slabs(tt.geom, W)
    one, two = {}, {}
    emulated_kernel_acc(t(codes), E, h, w, stride, stats=one)
    emulated_kernel_acc(t(codes).to(torch.uint16), E, h, w, stride,
                        stats=two)
    assert one["slots"] == two["slots"] == _open_most(W, w, stride)
    assert two["steps"] == 2 * one["steps"] > 0


def test_emulated_walk_at_the_paper_point_and_a_wide_ring():
    """At the paper's point (96x96 windows over 128-wide frames, stride 8)
    the walk takes 192 K steps and 5 slots, the numbers the card's
    ``int_expanded_occupancy`` reports in ``chip_smoke.py``; at the ragged
    shape of 21-wide windows at stride 3, 7 slots."""
    rng = np.random.default_rng(11)
    for (H, W, h, w, stride), want in (((96, 128, 96, 96, 8), (192, 5)),
                                       ((21, 46, 21, 21, 3), (None, 7))):
        codes = t(rng.integers(0, 256, (1, H, W)).astype(np.uint8))
        E = t(rng.integers(-128, 128, (1, h * W, 8)).astype(np.int8))
        stats = {}
        emulated_kernel_acc(codes, E, h, w, stride, stats=stats)
        assert stats["slots"] == want[1] == _open_most(W, w, stride)
        if want[0] is not None:
            assert stats["steps"] == want[0]


def test_emulated_fragment_columns_are_the_stored_columns():
    """The B registers' column map (n8 tile ni, column g: physical
    wn + 4g + ni), read through the m16n8k32 C fragment (lane (g, q) holds
    columns 2q, 2q + 1 of each n8 tile; accumulator 2 half + lc), gives
    lane q of each row the 8 consecutive columns wn + 8q + c, c = 4 lc + ni,
    that the close stores; the 4 lanes of a row and the 4 warps cover the
    128-column tile once."""
    seen = []
    for wn in range(0, 128, 32):
        for q in range(4):
            cols = {}
            for ni in range(4):
                for lc in range(2):
                    n = 2 * q + lc            # logical column of the tile
                    cols[ni + 4 * lc] = wn + 4 * n + ni
            assert [cols[c] for c in range(8)] == [wn + 8 * q + c
                                                   for c in range(8)]
            seen += cols.values()
    assert sorted(seen) == list(range(128))
