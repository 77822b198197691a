"""PyTorch port, the frame model and the pieces of the streaming step held
against the JAX package on the CPU: the (T+1)-th order statistic, batched
frame scores for every precision, the online perceptron fold, and the gate
and capture scans."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SCORE_ATOL, frames, models, t
from repro.core import hypersense as jhs
from repro.core import online as jonline
from repro.core.sensor_control import (ControllerConfig, RateController,
                                       SensorController)
from repro.kernels import ops as jops
from repro.sensing import stream as jstream
from repro_torch.core import hypersense as ths
from repro_torch.core import online as tonline
from repro_torch.kernels import ops as tops
from repro_torch.sensing import stream as tstream

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)


def close(a, b, atol=SCORE_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("t_detection", [0, 3, 48, 60])
def test_frame_detection_score(t_detection):
    maps = np.random.default_rng(t_detection).standard_normal(
        (4, 7, 7)).astype(np.float32)
    want = [np.asarray(jhs.frame_detection_score(jnp.asarray(m),
                                                 t_detection))
            for m in maps]
    np.testing.assert_array_equal(
        ths.frame_detection_score(t(maps), t_detection).numpy(), want)
    # a tensor t_detection takes the sort fallback, same values
    np.testing.assert_array_equal(
        ths.frame_detection_score(t(maps), torch.tensor(t_detection))
        .numpy(), want)


@pytest.mark.parametrize("precision,adc_bits", [
    ("float32", 8), ("int8", 8), ("int4", 4), ("binary", 8)])
def test_frame_scores_batch_matches_jax(precision, adc_bits):
    jm, tm = models(20, 200, t_detection=1)
    fr, _ = frames(21, 5)
    kw = dict(precision=precision, adc_bits=adc_bits)
    got = ths.frame_scores_batch(tm, t(fr), **kw)
    close(got, jhs.frame_scores_batch(jm, jnp.asarray(fr), backend="pallas",
                                      **kw))
    # integer input is taken as already-converted codes
    if precision != "float32":
        from repro_torch.sensing import adc
        codes = adc.pack_codes(adc.quantize_codes(t(fr), adc_bits), adc_bits)
        np.testing.assert_array_equal(
            ths.frame_scores_batch(tm, codes, **kw).numpy(), got.numpy())
    if precision == "float32":
        t_score = float(np.median(got.numpy()))
        tm2 = type(tm)(**{**tm.__dict__, "t_score": t_score})
        np.testing.assert_array_equal(ths.detect_batch(tm2, t(fr)).numpy(),
                                      got.numpy() > t_score)


def test_single_frame_paths_match_jax():
    jm, tm = models(22, 128, t_detection=2)
    fr, _ = frames(23, 1)
    for reuse in (True, False):
        close(ths.score_frame(tm, t(fr[0]), reuse=reuse),
              jhs.score_frame(jm, jnp.asarray(fr[0]), reuse=reuse), 1e-5)
    assert bool(ths.detect(tm, t(fr[0]))) == bool(
        jhs.detect(jm, jnp.asarray(fr[0])))
    # the oracle path and the kernel path agree inside the port
    close(ths.score_frame(tm, t(fr[0])),
          tops.fragment_score_map(t(fr[0]), tm.class_hvs, tm.B0, tm.b,
                                  h=tm.h, w=tm.w, stride=tm.stride), 1e-5)
    close(tops.fragment_score_map(t(fr[0]), tm.class_hvs, tm.B0, tm.b,
                                  h=tm.h, w=tm.w, stride=tm.stride),
          jops.fragment_score_map(jnp.asarray(fr[0]), jm.class_hvs, jm.B0,
                                  jm.b, h=jm.h, w=jm.w, stride=jm.stride))


@pytest.mark.parametrize("mode", ["label", "pseudo"])
def test_online_fold_matches_jax(mode):
    rng = np.random.default_rng(24)
    D = 96
    C = rng.standard_normal((2, D)).astype(np.float32)
    hvs = rng.uniform(-1, 1, (12, D)).astype(np.float32)
    labels = rng.integers(0, 2, 12).astype(np.int32)
    valid = np.ones(12, bool)
    valid[[3, 7, 11]] = False
    cfg = jonline.AdaptConfig(mode=mode, lr=0.5, confidence=0.05)
    tcfg = tonline.AdaptConfig(mode=mode, lr=0.5, confidence=0.05)
    want, wflags = jonline.apply_chunk(cfg, jnp.asarray(C), jnp.asarray(hvs),
                                       jnp.asarray(labels),
                                       jnp.asarray(valid))
    got, gflags = tonline.apply_chunk(tcfg, t(C), t(hvs), t(labels),
                                      t(valid))
    close(got, want, 1e-5)
    np.testing.assert_array_equal(gflags.numpy(), np.asarray(wflags))
    assert 0 < int(gflags.sum()) < 9        # some updates, not all
    # a masked step leaves the state bitwise untouched
    same, _ = tonline.apply_chunk(tcfg, t(C), t(hvs), t(labels),
                                  torch.zeros(12, dtype=torch.bool))
    assert torch.equal(same, t(C))


@pytest.mark.parametrize("hold,decim", [(0, 1), (2, 1), (3, 4), (1, 7)])
def test_gate_and_control_scans_match_reference(hold, decim):
    fired = np.random.default_rng(hold * 10 + decim).random(200) < 0.15
    got, holds = tstream.gate_scan(torch.from_numpy(fired), hold)
    want, wholds = jstream.gate_scan(jnp.asarray(fired), hold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(holds.numpy(), np.asarray(wholds))
    ctrl = SensorController(ControllerConfig(hold_frames=hold))
    np.testing.assert_array_equal(got.numpy(),
                                  [ctrl.step(bool(f)) for f in fired])
    out = tstream.control_scan(torch.from_numpy(fired), hold, decim, 1, 2)
    ref = jstream.control_scan(jnp.asarray(fired), hold, decim, 1, 2)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rate = RateController(ControllerConfig(hold_frames=hold,
                                           base_rate_hz=1.0,
                                           active_rate_hz=float(decim)))
    steps = np.array([rate.step(bool(f)) for f in fired])
    s0, g0, _, _ = tstream.control_scan(torch.from_numpy(fired), hold,
                                        decim)
    np.testing.assert_array_equal(s0.numpy(), steps[:, 0])
    np.testing.assert_array_equal(g0.numpy(), steps[:, 1])


def test_hp_capture_matches_jax():
    fr, _ = frames(25, 6)
    gated = np.array([1, 0, 1, 1, 1, 0], bool)
    for k in (2, 6):
        got = tstream.hp_capture(t(fr), t(gated), 5, k, 12)
        want = jstream.hp_capture(jnp.asarray(fr), jnp.asarray(gated),
                                  jnp.int32(5), k, 12)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
