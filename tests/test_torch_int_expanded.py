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

def emulated_kernel_acc(codes, E, h, w, stride, chunk=32):
    """``csrc/int_expanded.cu``'s window sums, vectorized over (frame, row
    band, D-tile, column): the frame columns the windows use walked in
    steps of ``chunk``; per column ``G = sum_r code * E[r*W + i]``; the
    running sum ``run`` stored in ring slot ``kx % ceil(w / stride)`` where
    window ``kx`` opens, and ``run - slot`` where it closes, all modulo
    2^32 (the kernel's unsigned adds) and read back as int32."""
    N, H, W = codes.shape
    n_dt, _, td = E.shape
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    last = (mx - 1) * stride + w
    slots = -(-w // stride)
    M32 = (1 << 32) - 1
    Er = E.reshape(n_dt, h, W, td).to(torch.int64)
    x = codes.to(torch.int64)
    ky = torch.arange(my) * stride
    ring = torch.zeros((slots, N, my, n_dt, td), dtype=torch.int64)
    run = torch.zeros((N, my, n_dt, td), dtype=torch.int64)
    out = torch.zeros((N, my, n_dt, mx, td), dtype=torch.int64)
    for i0 in range(0, last, chunk):
        for i in range(i0, min(i0 + chunk, last)):
            g = sum(x[:, ky + r, i][:, :, None, None] * Er[:, r, i]
                    for r in range(h))
            if i % stride == 0 and i // stride < mx:
                ring[(i // stride) % slots] = run
            run = (run + g) & M32
            first = i - w + 1
            if first >= 0 and first % stride == 0:
                kx = first // stride
                out[:, :, :, kx] = (run - ring[kx % slots]) & M32
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


@pytest.mark.parametrize("case", CASES + [(2, 12, 23, 3, 7, 3, 128, 128)])
def test_emulated_kernel_walk_bitwise(case):
    N, H, W, h, w, stride, D, block_d = case
    codes, _, tt = _setup(case)
    E = tie.expand_slabs(tt.geom, W)
    got = emulated_kernel_acc(t(codes), E, h, w, stride)
    want = tssi.int_window_acc(t(codes), tt.geom, h=h, w=w, stride=stride)
    assert torch.equal(got, want)


def test_emulated_kernel_walk_wraps_like_int32():
    """Window sums past int32 (outside the bounds contract) wrap the same
    way in the kernel's running-sum form as in a direct int32 sum: the
    unsigned adds are exact modulo 2^32."""
    h, w, stride, W, td = 2, 4, 2, 8, 4
    codes = torch.full((1, h, W), 2**30, dtype=torch.int64)
    E = torch.full((1, h * W, td), 3, dtype=torch.int8)
    got = emulated_kernel_acc(codes, E, h, w, stride)
    direct = (torch.tensor(2**30 * 3 * h * w, dtype=torch.int64)
              & ((1 << 32) - 1))
    direct = direct - (1 << 32) if direct >= 1 << 31 else direct
    assert (got == int(direct)).all()
