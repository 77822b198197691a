"""PyTorch port, the slice as a whole: the JAX ``StreamRunner`` (Pallas
kernels in interpret mode) against the port's ``StreamRunner(device="cpu")``
on the same frames, for every precision, open loop, closed loop and
online adaptation, with a padded tail chunk; then the port's own bitwise
invariants (slicing is invisible, runs are deterministic).

Scores agree within ``SCORE_ATOL``; every score sits more than
``DECISION_MARGIN`` from ``t_score``, so the gate, capture log and HP
drains must agree exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (SCORE_ATOL, assert_margin, frames, models,
                           pick_threshold, t)
from repro.core.online import AdaptConfig as JAdapt
from repro.core.sensor_control import CaptureConfig as JCapture
from repro.core.sensor_control import ControllerConfig as JController
from repro.sensing import stream as jstream
from repro_torch.core import hypersense as ths
from repro_torch.core.online import AdaptConfig
from repro_torch.core.sensor_control import CaptureConfig, ControllerConfig
from repro_torch.sensing import adc as tadc
from repro_torch.sensing import stream as tstream

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

N_FRAMES, CHUNK, BLOCK_D = 20, 8, 128     # 20 = 8 + 8 + a padded tail of 4
BITS = {"float32": 4, "int8": 8, "int4": 4, "binary": 8}
CTRL = dict(hold_frames=2, base_rate_hz=10.0, active_rate_hz=30.0)


def runner_kwargs(precision, loop):
    kw = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=BITS[precision],
              precision=precision)
    jkw, tkw = dict(kw, backend="pallas"), dict(kw, device="cpu")
    if loop == "closed":
        jkw["control"] = JCapture(hp_bits=12, hp_buffer=3)
        tkw["control"] = CaptureConfig(hp_bits=12, hp_buffer=3)
    if loop == "adapt":
        jkw["adapt"] = JAdapt(mode="label", lr=0.5)
        tkw["adapt"] = AdaptConfig(mode="label", lr=0.5)
    return jkw, tkw


def scenario_models(precision, D, seed=30, quantiles=(0.25, 0.75)):
    """Both models, with ``t_score`` placed in a wide gap of the frozen
    scores so that no decision sits near the threshold."""
    fr, labels = frames(seed + 1, N_FRAMES)
    _, tm = models(seed, D)
    view = (tadc.quantize(t(fr), BITS[precision]) if precision == "float32"
            else t(fr))
    s = ths.frame_scores_batch(tm, view, precision=precision,
                               adc_bits=BITS[precision])
    t_score = pick_threshold(s.numpy(), *quantiles)
    jm, tm = models(seed, D, t_score=t_score)
    return jm, tm, fr, labels


SCENARIOS = [(p, loop, D) for i, p in enumerate(BITS)
             for j, loop in enumerate(("open", "closed", "adapt"))
             for D in [(256, 200)[(i + j) % 2]]]


@pytest.mark.parametrize("precision,loop,D", SCENARIOS)
def test_stream_runner_matches_jax(precision, loop, D):
    # the closed loop fires less often, so that idle frames are skipped
    jm, tm, fr, labels = scenario_models(
        precision, D, quantiles=(0.6, 0.9) if loop == "closed" else
        (0.25, 0.75))
    jkw, tkw = runner_kwargs(precision, loop)
    feed = labels if loop == "adapt" else None
    jr = jstream.StreamRunner(jm, JController(**CTRL), **jkw)
    tr = tstream.StreamRunner(tm, ControllerConfig(**CTRL), **tkw)
    js, jf, jg = jr.process(fr, labels=feed)
    ts, tf, tg = tr.process(fr, labels=feed)
    assert_margin(js, jm.t_score)
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tg, jg)
    assert 0 < tf.sum() < N_FRAMES           # the gate saw both outcomes
    jlog, tlog = jr.capture_log, tr.capture_log
    np.testing.assert_array_equal(tlog.sampled, jlog.sampled)
    np.testing.assert_array_equal(tlog.gated, jlog.gated)
    assert (tlog.lp_bits, tlog.hp_bits, tlog.frame_pixels) == (
        jlog.lp_bits, jlog.hp_bits, jlog.frame_pixels)
    jidx, jhp = jr.drain_hp()
    tidx, thp = tr.drain_hp()
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(thp, jhp)
    assert tr.hp_dropped == jr.hp_dropped
    if loop == "closed":
        assert not tlog.sampled.all() and len(tidx) > 0
    if loop == "adapt":
        assert not np.array_equal(np.asarray(jr.class_hvs),
                                  np.asarray(jm.class_hvs))
        np.testing.assert_allclose(tr.class_hvs.numpy(),
                                   np.asarray(jr.class_hvs), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("precision", ["int8", "float32"])
def test_super_chunk_fleet_step_matches_jax(precision):
    """S=3 streams, per-stream adaptation, a masked slot parked in place,
    the closed loop: one step of the shared core against the reference."""
    jm, tm, fr, labels = scenario_models(precision, 200, seed=40)
    S, C = 3, 6
    raw = fr[:S * C].reshape(S, C, *fr.shape[1:])
    lab = labels[:S * C].reshape(S, C)
    bits = BITS[precision]
    if precision == "float32":
        jframes = np.asarray(jstream.adc_view(jnp.asarray(raw.reshape(
            S * C, *fr.shape[1:])), bits)).reshape(raw.shape)
        tframes = t(jframes)
    else:
        jframes = np.asarray(jstream.adc_view_codes(jnp.asarray(raw.reshape(
            S * C, *fr.shape[1:])), bits)).reshape(raw.shape)
        tframes = t(jframes)
    mask = np.array([True, False, True])
    Cs = np.stack([np.asarray(jm.class_hvs) * (1 + 0.1 * s)
                   for s in range(S)])
    jstate = dataclasses.replace(
        jstream.init_stream_state(jnp.asarray(Cs), S),
        holds=jnp.array([0, 1, 2], jnp.int32),
        phases=jnp.array([1, 0, 2], jnp.int32))
    tstate = dataclasses.replace(
        tstream.init_stream_state(t(Cs), S),
        holds=torch.tensor([0, 1, 2], dtype=torch.int32),
        phases=torch.tensor([1, 0, 2], dtype=torch.int32))
    common = dict(h=tm.h, w=tm.w, stride=tm.stride, nonlinearity="rff",
                  t_detection=0, hold_frames=2, precision=precision,
                  adc_lsb=tadc.lsb(bits) if precision != "float32" else 1.0,
                  decim=3, park_masked=True)
    jout = jstream.super_chunk_step(
        jnp.asarray(jframes), jstate, jm.B0, jm.b,
        jstream.model_geometry(jm, fr.shape[-1], BLOCK_D, precision),
        jnp.float32(jm.t_score), jnp.int32(C - 1), jnp.asarray(lab),
        jnp.asarray(mask), backend="pallas",
        adapt=JAdapt(mode="label", scope="per-stream"), **common)
    tout = tstream.super_chunk_fn(
        tframes, tstate, tm.B0, tm.b,
        tstream.model_geometry(tm, fr.shape[-1], BLOCK_D, precision),
        tm.t_score, C - 1, t(lab), torch.from_numpy(mask),
        adapt=AdaptConfig(mode="label", scope="per-stream"), **common)
    assert_margin(np.asarray(jout[0])[:, :C - 1], jm.t_score)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0,
                               atol=SCORE_ATOL)
    for a, b in zip(tout[1:4], jout[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js, ts = jout[4], tout[4]
    np.testing.assert_allclose(ts.class_hvs.numpy(),
                               np.asarray(js.class_hvs), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts.class_hvs[1].numpy(), Cs[1])  # parked
    np.testing.assert_array_equal(ts.holds.numpy(), np.asarray(js.holds))
    np.testing.assert_array_equal(ts.phases.numpy(), np.asarray(js.phases))
    assert ts.frame_idx == int(js.frame_idx) == C - 1


def test_simulate_stream_batched_matches_jax():
    jm, tm, fr, labels = scenario_models("int8", 200, seed=50)
    kw = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=8,
              precision="int8")
    want = jstream.simulate_stream_batched(jm, fr, labels,
                                           JController(hold_frames=2),
                                           backend="pallas", **kw)
    got = tstream.simulate_stream_batched(tm, fr, labels,
                                          ControllerConfig(hold_frames=2),
                                          device="cpu", **kw)
    np.testing.assert_array_equal(got.decisions, want.decisions)
    np.testing.assert_array_equal(got.gated_on, want.gated_on)
    assert (got.duty_cycle, got.missed_positive, got.false_active) == (
        want.duty_cycle, want.missed_positive, want.false_active)


# ---------------------------------------------------------------------------
# within-port invariants, bitwise
# ---------------------------------------------------------------------------

def _run_sliced(tm, fr, labels, cuts, **kw):
    r = tstream.StreamRunner(tm, ControllerConfig(**CTRL), device="cpu",
                             **kw)
    out = []
    for lo, hi in zip((0, *cuts), (*cuts, len(fr))):
        feed = labels[lo:hi] if kw.get("adapt") else None
        out.append(r.process(fr[lo:hi], labels=feed))
    s, f, g = (np.concatenate(x) for x in zip(*out))
    return s, f, g, r.class_hvs.clone(), r.capture_log, r.drain_hp()


#: adaptation scores each chunk with the classifier of its start, so its
#: slices keep the chunk grid; frozen and closed-loop runs take any cuts
#: (the closed loop with a full-chunk HP buffer, which never drops)
@pytest.mark.parametrize("precision,loop,sigma,slicings", [
    ("float32", "open", 0.02, [(7, 16), (1, 2, 3, 11)]),
    ("int4", "closed", 0.02, [(7, 16), (1, 2, 3, 11)]),
    ("int8", "adapt", 0.0, [(8, 16), (8,)]),
    ("binary", "adapt", 0.0, [(16,)])])
def test_slicing_is_invisible_and_runs_are_deterministic(precision, loop,
                                                         sigma, slicings):
    _, tm, fr, labels = scenario_models(precision, 200, seed=60)
    _, tkw = runner_kwargs(precision, loop)
    tkw.pop("device")
    tkw.update(adc_sigma=sigma, adc_seed=7)
    if loop == "closed":
        tkw["control"] = CaptureConfig(hp_bits=12)
    whole = _run_sliced(tm, fr, labels, (), **tkw)
    for cuts in slicings:
        sliced = _run_sliced(tm, fr, labels, cuts, **tkw)
        for a, b in zip(whole[:3], sliced[:3]):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(whole[3], sliced[3])
        np.testing.assert_array_equal(whole[4].sampled, sliced[4].sampled)
        np.testing.assert_array_equal(whole[4].gated, sliced[4].gated)
        np.testing.assert_array_equal(whole[5][0], sliced[5][0])
        np.testing.assert_array_equal(whole[5][1], sliced[5][1])
    again = _run_sliced(tm, fr, labels, (), **tkw)
    np.testing.assert_array_equal(again[0], whole[0])
    assert torch.equal(again[3], whole[3])


def test_runner_validation_and_drain_shape():
    _, tm, fr, _ = scenario_models("int8", 200, seed=70)
    with pytest.raises(ValueError, match="consumes ADC codes"):
        tstream.StreamRunner(tm, precision="int8", device="cpu")
    with pytest.raises(ValueError, match="per-stream"):
        tstream.StreamRunner(tm, adapt=AdaptConfig(scope="per-stream"),
                             device="cpu")
    with pytest.raises(ValueError, match="labels"):
        tstream.StreamRunner(tm, adapt=AdaptConfig(), device="cpu").process(
            fr)
    codes = tadc.quantize_codes(t(fr), 8)
    with pytest.raises(ValueError, match="raw frames"):
        tstream.StreamRunner(tm, adc_bits=8, precision="int8",
                             control=CaptureConfig(),
                             device="cpu").process(codes)
    r = tstream.StreamRunner(tm, adc_bits=8, precision="int8",
                             control=CaptureConfig(hp_buffer=0),
                             device="cpu")
    r.process(codes)
    idx, hp = r.drain_hp()
    assert idx.shape == (0,) and hp.shape == (0, *fr.shape[1:])
