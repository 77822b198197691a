"""PyTorch port, the two scoring modules held against the JAX package on
the CPU: geometry and class tiles bitwise, float scores at ``SCORE_ATOL``
against the Pallas kernel in interpret mode, the int32 window accumulators
bitwise against ``_int_window_acc``, and int scores against both the
interpret-mode kernel and its jnp twin. Each D case is run twice: one that
``block_d`` divides (two tiles, exercising the fold) and one that it does
not (the single ``D``-wide tile the paper's D=5000 hits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FRAG, H, SCORE_ATOL, STRIDE, W, model_arrays, t
from repro.kernels import ops as jops
from repro.kernels import sliding_scores as jss
from repro.kernels import sliding_scores_int as jssi
from repro.sensing import adc as jadc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sliding_scores as tss
from repro_torch.kernels import sliding_scores_int as tssi
from repro_torch.sensing import adc as tadc

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

BLOCK_D = 128
#: (D, tiles): 256 -> two 128-wide tiles; 200 -> one 200-wide tile
D_CASES = [256, 200]
KW = dict(h=FRAG, w=FRAG, stride=STRIDE)
MX = (W - FRAG) // STRIDE + 1


def both(seed, D):
    C, B0, b = model_arrays(seed, D)
    return (C, B0, b), (jnp.asarray(C), jnp.asarray(B0), jnp.asarray(b))


def frames_np(seed, n):
    return np.random.default_rng(seed).uniform(0, 1.5, (n, H, W)).astype(
        np.float32)


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def close(a, b, atol=SCORE_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# float scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", D_CASES)
def test_geometry_and_class_tiles_bitwise(D):
    (C, B0, b), (jC, jB0, jb) = both(1, D)
    jg = jss.precompute_geometry(jB0, jb, W=W, w=FRAG, stride=STRIDE,
                                 block_d=BLOCK_D)
    tg = tss.precompute_geometry(t(B0), t(b), W=W, w=FRAG, stride=STRIDE,
                                 block_d=BLOCK_D)
    assert tg.block_d == jg.block_d == (BLOCK_D if D % BLOCK_D == 0 else D)
    eq(tg.slabs, jg.slabs)
    eq(tg.bias_t, jg.bias_t)
    eq(tg.idx, jg.idx)
    jt, tt = jss.retile_classes(jg, jC), tss.retile_classes(tg, t(C))
    eq(tt.cpos_t, jt.cpos_t)
    eq(tt.cneg_t, jt.cneg_t)
    close(tt.cpos_norm, jt.cpos_norm, 1e-5)
    close(tt.cneg_norm, jt.cneg_norm, 1e-5)
    Cs = np.random.default_rng(2).standard_normal((3, 2, D)).astype(
        np.float32)
    jf = jss.retile_classes_fleet(jg, jnp.asarray(Cs))
    tf = tss.retile_classes_fleet(tg, t(Cs))
    eq(tf.cpos_t, jf.cpos_t)
    eq(tf.cneg_t, jf.cneg_t)
    close(tf.cpos_norm, jf.cpos_norm, 1e-5)
    # summed-area tables over the whole frame: float32 roundings relative
    # to the table's running total
    np.testing.assert_allclose(
        tss.window_norms_batch(t(frames_np(3, 2)), **KW).numpy(),
        np.asarray(jss.window_norms_batch(jnp.asarray(frames_np(3, 2)),
                                          **KW)), rtol=2e-6)


@pytest.mark.parametrize("nonlinearity", ["rff", "linear"])
@pytest.mark.parametrize("D", D_CASES)
def test_float_scores_match_jax_kernel(D, nonlinearity):
    (C, B0, b), (jC, jB0, jb) = both(4, D)
    fr = frames_np(5, 3)
    jt = jss.precompute_tiles(jB0, jb, jC, W=W, w=FRAG, stride=STRIDE,
                              block_d=BLOCK_D)
    tt = tss.precompute_tiles(t(B0), t(b), t(C), W=W, w=FRAG,
                              stride=STRIDE, block_d=BLOCK_D)
    want = jss.fragment_scores_batch(jnp.asarray(fr), jt,
                                      nonlinearity=nonlinearity,
                                      interpret=True, **KW)
    got = tss.fragment_scores_batch(t(fr), tt, nonlinearity=nonlinearity,
                                    **KW)
    assert got.shape == (3, MX, MX)
    close(got, want)
    close(tss.fragment_scores(t(fr[1]), tt, nonlinearity=nonlinearity,
                              **KW), want[1])


@pytest.mark.parametrize("D", D_CASES)
def test_float_scores_per_stream_tiles(D):
    (C, B0, b), (jC, jB0, jb) = both(6, D)
    Cs = np.random.default_rng(7).standard_normal((2, 2, D)).astype(
        np.float32)
    fr = frames_np(8, 4)                       # S=2 streams x C=2 frames
    jg = jss.precompute_geometry(jB0, jb, W=W, w=FRAG, stride=STRIDE,
                                 block_d=BLOCK_D)
    tg = tss.precompute_geometry(t(B0), t(b), W=W, w=FRAG, stride=STRIDE,
                                 block_d=BLOCK_D)
    want = jss.fragment_scores_batch(
        jnp.asarray(fr), jss.retile_classes_fleet(jg, jnp.asarray(Cs)),
        interpret=True, frames_per_stream=2, **KW)
    got = tss.fragment_scores_batch(
        t(fr), tss.retile_classes_fleet(tg, t(Cs)), frames_per_stream=2,
        **KW)
    close(got, want)
    # stream s's frames score exactly as against its classifier alone
    for s in range(2):
        alone = tss.fragment_scores_batch(t(fr[2 * s:2 * s + 2]),
                                          tss.retile_classes(tg, t(Cs[s])),
                                          **KW)
        close(got[2 * s:2 * s + 2], alone, 1e-6)
    with pytest.raises(ValueError, match="frames_per_stream"):
        tss.fragment_scores_batch(t(fr), tss.retile_classes_fleet(tg, t(Cs)),
                                  **KW)


@pytest.mark.parametrize("D", D_CASES)
def test_ops_dispatch_matches_jax(D):
    (C, B0, b), (jC, jB0, jb) = both(9, D)
    fr = frames_np(10, 4)
    kw = dict(KW, block_d=BLOCK_D)
    close(tops.fragment_score_map(t(fr[0]), t(C), t(B0), t(b), **kw),
          jops.fragment_score_map(jnp.asarray(fr[0]), jC, jB0, jb, **kw))
    close(tops.fragment_score_map_fleet(t(fr.reshape(2, 2, H, W)), t(C),
                                        t(B0), t(b), **kw),
          jops.fragment_score_map_fleet(jnp.asarray(fr.reshape(2, 2, H, W)),
                                        jC, jB0, jb, **kw))


# ---------------------------------------------------------------------------
# int scorer
# ---------------------------------------------------------------------------

PRECISIONS = {"int8": ("int8", False, 8), "int4": ("int8", True, 4),
              "binary": ("binary", False, 8)}


def codes_np(seed, n, bits):
    fr = frames_np(seed, n)
    return np.asarray(jadc.pack_codes(
        jadc.quantize_codes(jnp.asarray(fr), bits), bits))


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("D", D_CASES)
def test_int_geometry_and_window_acc_bitwise(D, precision):
    mode, packed, bits = PRECISIONS[precision]
    (C, B0, b), (jC, jB0, jb) = both(11, D)
    jg = jssi.precompute_geometry_int(jB0, jb, W=W, w=FRAG, stride=STRIDE,
                                      block_d=BLOCK_D, mode=mode)
    tg = tssi.precompute_geometry_int(t(B0), t(b), W=W, w=FRAG,
                                      stride=STRIDE, block_d=BLOCK_D,
                                      mode=mode)
    eq(tg.slabs_q, jg.slabs_q)
    eq(tg.win_mask, jg.win_mask)
    eq(tg.bias_t, jg.bias_t)
    eq(tg.idx, jg.idx)
    # int8: a max, exact; binary: a mean, whose summation order differs
    np.testing.assert_allclose(float(tg.slab_scale), float(jg.slab_scale),
                               rtol=0 if mode == "int8" else 1e-6)
    jt, tt = jssi.retile_classes_int(jg, jC), tssi.retile_classes_int(tg,
                                                                     t(C))
    eq(tt.cpos_t, jt.cpos_t)
    eq(tt.cneg_t, jt.cneg_t)
    close(tt.cpos_norm, jt.cpos_norm, 1e-5)
    Cs = np.random.default_rng(12).standard_normal((2, 2, D)).astype(
        np.float32)
    eq(tssi.retile_classes_int_fleet(tg, t(Cs)).cpos_t,
       jssi.retile_classes_int_fleet(jg, jnp.asarray(Cs)).cpos_t)

    codes = codes_np(13, 2, bits)
    kcodes = np.asarray(jadc.pack_nibbles(jnp.asarray(codes))) if packed \
        else codes
    got = tssi.int_window_acc(t(kcodes), tg, packed=packed, **KW)
    assert got.dtype == torch.int32
    my, n_dt, td = MX, jg.slabs_q.shape[0], jg.block_d
    assert got.shape == (2, my, n_dt, MX, td)
    full = codes.astype(np.int32)
    for n in range(2):
        for ky in range(my):
            block = jnp.asarray(full[n, ky * STRIDE: ky * STRIDE + FRAG])
            for dt in range(n_dt):
                want = jssi._int_window_acc(block, jg.slabs_q[dt],
                                            jg.win_mask, h=FRAG, W=W, td=td)
                eq(got[n, ky, dt], want)


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("D", D_CASES)
def test_int_scores_match_jax(D, precision):
    mode, packed, bits = PRECISIONS[precision]
    (C, B0, b), (jC, jB0, jb) = both(14, D)
    codes = codes_np(15, 3, bits)
    jcodes = jnp.asarray(codes)
    if packed:
        jcodes = jadc.pack_nibbles(jcodes)
    jt = jssi.precompute_tiles_int(jB0, jb, jC, W=W, w=FRAG, stride=STRIDE,
                                   block_d=BLOCK_D, mode=mode)
    tt = tssi.precompute_tiles_int(t(B0), t(b), t(C), W=W, w=FRAG,
                                   stride=STRIDE, block_d=BLOCK_D,
                                   mode=mode)
    got = tssi.fragment_scores_batch_int(t(np.asarray(jcodes)), tt,
                                         packed=packed, **KW)
    close(got, jssi.fragment_scores_batch_int(jcodes, jt, interpret=True,
                                              packed=packed, **KW))
    close(got, jssi.fragment_scores_batch_int_ref(jcodes, jt, packed=packed,
                                                  **KW))
    # per-stream class tiles: stream n // C reads its own classifier
    Cs = np.random.default_rng(16).standard_normal((3, 2, D)).astype(
        np.float32)
    jf = jssi.retile_classes_int_fleet(jt.geom, jnp.asarray(Cs))
    tf = tssi.retile_classes_int_fleet(tt.geom, t(Cs))
    close(tssi.fragment_scores_batch_int(t(np.asarray(jcodes)), tf,
                                         frames_per_stream=1, packed=packed,
                                         **KW),
          jssi.fragment_scores_batch_int_ref(jcodes, jf, frames_per_stream=1,
                                             packed=packed, **KW))
    # the fleet dispatch flattens (S, C) into the same single batch
    fleet = tops.fragment_score_map_fleet_int(
        t(np.asarray(jcodes))[None], t(C), t(B0), t(b), tiles=tt,
        packed=packed, **KW)
    eq(fleet[0], got)


def test_int_scorer_rejects_float_input_and_uint16_codes_widen():
    (C, B0, b), _ = both(17, 200)
    tt = tssi.precompute_tiles_int(t(B0), t(b), t(C), W=W, w=FRAG,
                                   stride=STRIDE, block_d=BLOCK_D)
    with pytest.raises(TypeError, match="integer ADC codes"):
        tssi.fragment_scores_batch_int(t(frames_np(18, 1)), tt, **KW)
    c8 = t(codes_np(19, 2, 8))
    eq(tssi.fragment_scores_batch_int(c8.to(torch.uint16), tt, **KW),
       tssi.fragment_scores_batch_int(c8, tt, **KW))


def test_int_datapath_bounds():
    for args in [(8, 32, 32, 8, 8), (4, 128, 128, 96, 96), (12, 64, 64, 16,
                                                            16)]:
        jb = jssi.int_datapath_bounds(*args, stride=4)
        tb = tssi.int_datapath_bounds(*args, stride=4)
        assert (tb["sumsq"], tb["acc"], tb["int32_max"]) == (
            jb["sumsq"], jb["acc"], jb["int32_max"])
    # the paper's operating point fits one H100 block (the int kernel's own
    # block: no frame, window or tile width sizes it)
    paper = tssi.int_datapath_bounds(4, 128, 128, 96, 96, stride=8)
    assert paper["fits"] and paper["smem_bytes"] == tssi.smem_bytes()
    assert paper["smem_bytes"] < paper["smem_limit_bytes"] == 232_448
    tssi.assert_int_datapath_fits(8, 128, 128, 96, 96, stride=8)
    with pytest.raises(ValueError, match="overflow int32"):
        tssi.assert_int_datapath_fits(16, 512, 512, 96, 96, stride=8)
    # a 4096-wide frame, too wide for the CUDA-core kernel's block (a frame
    # row and per-window sums in shared memory), runs in the same block
    wide = tssi.int_datapath_bounds(1, 8, 4096, 8, 8, stride=8)
    assert wide["fits"] and wide["smem_bytes"] == paper["smem_bytes"]
    tssi.assert_int_datapath_fits(1, 8, 4096, 8, 8, stride=8)
    # the im2col scratch: 5 x 5 windows of 96 x 96 codes, one byte each, per
    # frame at the paper's operating point; a 32-frame chunk is one call
    assert paper["im2col_bytes_per_frame"] == 230_400
    assert paper["im2col_budget_bytes"] == tssi.IM2COL_BUDGET_BYTES == 2**30
    assert tssi.frame_runs(32, 230_400, 32) == [(0, 32)]
    assert 32 * paper["im2col_bytes_per_frame"] == 7_372_800
    assert tssi.int_datapath_bounds(10, 64, 64, 16, 16, stride=4)[
        "im2col_bytes_per_frame"] == 2 * 13 * 13 * 256     # uint16: 2 passes
    # 4-bit codes, 640 x 640 frames, 96 x 96 windows, stride 1: 545 x 545
    # windows of 9216 bytes are over the budget for one frame
    big = tssi.int_datapath_bounds(4, 640, 640, 96, 96, stride=1)
    assert big["im2col_bytes_per_frame"] == 2_737_382_400
    assert max(big["sumsq"], big["acc"]) <= big["int32_max"]
    assert not big["fits"]
    with pytest.raises(ValueError, match="2737382400 B per frame"):
        tssi.assert_int_datapath_fits(4, 640, 640, 96, 96, stride=1)


@pytest.mark.parametrize("N, per_frame, C, budget", [
    (32, 230_400, 32, 2**30),       # the paper's chunk: one run
    (32, 100, 32, 700),             # shared classes: runs of 7
    (12, 100, 4, 900),              # 3 streams of 4: runs of 2 streams
    (12, 100, 4, 300),              # runs of 3 inside each stream
    (5, 2000, 5, 1000),             # a frame over the budget runs alone
])
def test_int_frame_runs_cover_the_chunk(N, per_frame, C, budget):
    """The int wrapper's runs of frames (one call of the C entry each)
    cover the chunk in order, keep each call's im2col scratch within the
    budget (a frame alone where one does not fit), and either hold whole
    streams from a stream boundary or lie inside one stream."""
    runs = tssi.frame_runs(N, per_frame, C, budget)
    assert [lo for lo, _ in runs] == [0] + [hi for _, hi in runs[:-1]]
    assert runs[-1][1] == N
    for lo, hi in runs:
        assert hi > lo and (hi - lo == 1 or (hi - lo) * per_frame <= budget)
        assert (lo % C == 0 and (hi - lo) % C in (0, N % C)) \
            or lo // C == (hi - 1) // C
    assert tadc.codes_dtype(8) == torch.uint8
