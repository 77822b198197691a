"""PyTorch port, the fleet: the JAX ``FleetRunner`` (Pallas kernels in
interpret mode) against the port's ``FleetRunner(device="cpu")`` on the
same ``(S, n, H, W)`` frames, for every precision, open loop, closed loop
and per-stream adaptation (and shared adaptation at one precision), with
a padded tail chunk; then the port's own bitwise invariants: a fleet
equals S independent ``StreamRunner``s, state carries across ``process``
calls, the ADC inside the runner equals a pre-quantized input, and each
stream draws its own noise.

Scores agree within ``SCORE_ATOL``; every score sits more than
``DECISION_MARGIN`` from ``t_score``, so the gate, capture log and HP
drains must agree exactly."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (SCORE_ATOL, assert_margin, frames, models,
                           pick_threshold, t)
from repro.core.online import AdaptConfig as JAdapt
from repro.core.sensor_control import CaptureConfig as JCapture
from repro.core.sensor_control import ControllerConfig as JController
from repro.sensing import fleet as jfleet
from repro_torch.core import hypersense as ths
from repro_torch.core.online import AdaptConfig
from repro_torch.core.sensor_control import CaptureConfig, ControllerConfig
from repro_torch.sensing import adc as tadc
from repro_torch.sensing import fleet as tfleet
from repro_torch.sensing import stream as tstream

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

S, N_FRAMES, CHUNK, BLOCK_D = 3, 20, 8, 128   # 20 = 8 + 8 + a tail of 4
BITS = {"float32": 4, "int8": 8, "int4": 4, "binary": 8}
CTRL = dict(hold_frames=2, base_rate_hz=10.0, active_rate_hz=30.0)


def fleet_frames(seed):
    """``(S, n, H, W)`` frames, each stream its own draw, and ``(S, n)``
    labels."""
    fr, lab = zip(*(frames(seed + s, N_FRAMES) for s in range(S)))
    return np.stack(fr), np.stack(lab)


def adapt_configs(loop):
    scope = {"adapt": "per-stream", "shared": "shared"}.get(loop)
    if scope is None:
        return None, None
    return (JAdapt(mode="label", lr=0.5, scope=scope),
            AdaptConfig(mode="label", lr=0.5, scope=scope))


def runner_kwargs(precision, loop):
    kw = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=BITS[precision],
              precision=precision)
    jkw, tkw = dict(kw, backend="pallas"), dict(kw, device="cpu")
    if loop == "closed":
        jkw["control"] = JCapture(hp_bits=12, hp_buffer=3)
        tkw["control"] = CaptureConfig(hp_bits=12, hp_buffer=3)
    jkw["adapt"], tkw["adapt"] = adapt_configs(loop)
    return jkw, tkw


def scenario_models(precision, D, seed=80, quantiles=(0.25, 0.75)):
    """Both models, with ``t_score`` placed in a wide gap of the fleet's
    frozen scores so that no decision sits near the threshold."""
    fr, labels = fleet_frames(seed + 1)
    _, tm = models(seed, D)
    flat = t(fr.reshape(-1, *fr.shape[2:]))
    view = (tadc.quantize(flat, BITS[precision]) if precision == "float32"
            else flat)
    s = ths.frame_scores_batch(tm, view, precision=precision,
                               adc_bits=BITS[precision])
    t_score = pick_threshold(s.numpy(), *quantiles)
    jm, tm = models(seed, D, t_score=t_score)
    return jm, tm, fr, labels


SCENARIOS = [(p, loop, D) for i, p in enumerate(BITS)
             for j, loop in enumerate(("open", "closed", "adapt"))
             for D in [(256, 200)[(i + j) % 2]]] + [("int8", "shared", 200)]


@pytest.mark.parametrize("precision,loop,D", SCENARIOS)
def test_fleet_runner_matches_jax(precision, loop, D):
    # the closed loop fires less often, so that idle frames are skipped
    jm, tm, fr, labels = scenario_models(
        precision, D, quantiles=(0.6, 0.9) if loop == "closed" else
        (0.25, 0.75))
    jkw, tkw = runner_kwargs(precision, loop)
    feed = labels if loop in ("adapt", "shared") else None
    jr = jfleet.FleetRunner(jm, JController(**CTRL), **jkw)
    tr = tfleet.FleetRunner(tm, ControllerConfig(**CTRL), **tkw)
    js, jf, jg = jr.process(fr, labels=feed)
    ts, tf, tg = tr.process(fr, labels=feed)
    assert ts.shape == (S, N_FRAMES)
    assert_margin(js, jm.t_score)
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tg, jg)
    assert 0 < tf.sum() < tf.size            # the gate saw both outcomes
    jlog, tlog = jr.capture_log, tr.capture_log
    np.testing.assert_array_equal(tlog.sampled, jlog.sampled)
    np.testing.assert_array_equal(tlog.gated, jlog.gated)
    assert (tlog.lp_bits, tlog.hp_bits, tlog.frame_pixels) == (
        jlog.lp_bits, jlog.hp_bits, jlog.frame_pixels)
    jdrain, tdrain = jr.drain_hp(), tr.drain_hp()
    assert len(tdrain) == len(jdrain) == S
    for (tidx, thp), (jidx, jhp) in zip(tdrain, jdrain):
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(thp, jhp)
    assert tr.hp_dropped == jr.hp_dropped
    np.testing.assert_array_equal(tr.holds.numpy(), np.asarray(jr.holds))
    if loop == "closed":
        assert not tlog.sampled.all()
        assert sum(len(i) for i, _ in tdrain) > 0
    if loop in ("adapt", "shared"):
        assert not np.array_equal(np.asarray(jr.class_hvs),
                                  np.asarray(jm.class_hvs))
        assert tr.class_hvs.shape == ((S, 2, D) if loop == "adapt"
                                      else (2, D))
        np.testing.assert_allclose(tr.class_hvs.numpy(),
                                   np.asarray(jr.class_hvs), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# within-port invariants, bitwise
# ---------------------------------------------------------------------------

def _outputs(runner, fr, labels, cuts=()):
    """Everything a fleet run produces, fed in ``process`` calls cut at
    ``cuts``: scores, fired, gated, class_hvs, capture log, HP drains."""
    out = []
    for lo, hi in zip((0, *cuts), (*cuts, fr.shape[1])):
        out.append(runner.process(fr[:, lo:hi], labels=None if labels is None
                                  else labels[:, lo:hi]))
    s, f, g = (np.concatenate(x, axis=1) for x in zip(*out))
    return s, f, g, runner.class_hvs.clone(), runner.capture_log, \
        runner.drain_hp()


def _assert_same(a, b):
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(a[3], b[3])
    np.testing.assert_array_equal(a[4].sampled, b[4].sampled)
    np.testing.assert_array_equal(a[4].gated, b[4].gated)
    for (ia, fa), (ib, fb) in zip(a[5], b[5]):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(fa, fb)


#: (precision, loop, adc_sigma): the per-stream fleet folds stream s as a
#: one-stream runner with scope "shared" does
INDEPENDENT = [("float32", "open", 0.0), ("int4", "closed", 0.0),
               ("int8", "adapt", 0.0), ("binary", "adapt", 0.0),
               ("float32", "open", 0.02), ("int8", "closed", 0.02)]


@pytest.mark.parametrize("precision,loop,sigma", INDEPENDENT)
def test_fleet_equals_independent_runners(precision, loop, sigma):
    _, tm, fr, labels = scenario_models(precision, 200, seed=90)
    _, tkw = runner_kwargs(precision, loop)
    tkw.update(adc_sigma=sigma, adc_seed=11)
    feed = labels if loop == "adapt" else None
    got = _outputs(tfleet.FleetRunner(tm, ControllerConfig(**CTRL), **tkw),
                   fr, feed)
    for s in range(S):
        rkw = dict(tkw, adc_seed=tfleet.stream_seed(11, s))
        if loop == "adapt":
            rkw["adapt"] = AdaptConfig(mode="label", lr=0.5)
        r = tstream.StreamRunner(tm, ControllerConfig(**CTRL), **rkw)
        scores, fired, gated = r.process(
            fr[s], labels=None if feed is None else feed[s])
        np.testing.assert_array_equal(got[0][s], scores)
        np.testing.assert_array_equal(got[1][s], fired)
        np.testing.assert_array_equal(got[2][s], gated)
        log = r.capture_log
        np.testing.assert_array_equal(got[4].sampled[s], log.sampled)
        np.testing.assert_array_equal(got[4].gated[s], log.gated)
        idx, hp = r.drain_hp()
        np.testing.assert_array_equal(got[5][s][0], idx)
        np.testing.assert_array_equal(got[5][s][1], hp)
        if loop == "adapt":
            assert torch.equal(got[3][s], r.class_hvs)
    assert 0 < got[1].sum() < got[1].size
    if loop == "closed":
        assert not got[4].sampled.all()
        assert sum(len(idx) for idx, _ in got[5]) > 0


#: adaptation scores each chunk with the classifier of its start, so its
#: cuts keep the chunk grid (as in the reference); the others take any cut
SLICINGS = [("float32", "open", 0.02, (7, 10)), ("int4", "closed", 0.0,
                                                 (7, 10)),
            ("int8", "adapt", 0.0, (8, 16)), ("binary", "shared", 0.0,
                                              (8, 16))]


@pytest.mark.parametrize("precision,loop,sigma,cuts", SLICINGS)
def test_state_carries_across_process_calls(precision, loop, sigma, cuts):
    _, tm, fr, labels = scenario_models(precision, 256, seed=100)
    _, tkw = runner_kwargs(precision, loop)
    tkw.update(adc_sigma=sigma, adc_seed=3)
    if loop == "closed":
        tkw["control"] = CaptureConfig(hp_bits=12)
    feed = labels if loop in ("adapt", "shared") else None

    def run(c):
        return _outputs(tfleet.FleetRunner(tm, ControllerConfig(**CTRL),
                                           **tkw), fr, feed, c)

    whole = run(())
    _assert_same(whole, run(cuts))
    _assert_same(whole, run(()))


@pytest.mark.parametrize("precision", ["float32", "int8", "int4"])
def test_adc_in_the_runner_equals_pre_quantized_input(precision):
    _, tm, fr, _ = scenario_models(precision, 200, seed=110)
    bits = BITS[precision]
    _, tkw = runner_kwargs(precision, "open")
    got = tfleet.FleetRunner(tm, **tkw).process(fr)
    if precision == "float32":
        pre, tkw["adc_bits"] = tadc.quantize(t(fr), bits), None
    else:
        pre = tadc.quantize_codes(t(fr), bits)
    want = tfleet.FleetRunner(tm, **tkw).process(pre)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_streams_draw_their_own_noise():
    _, tm, fr, _ = scenario_models("float32", 200, seed=120)
    same = np.stack([fr[0], fr[0]])
    kw = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=4, device="cpu")
    s, _, _ = tfleet.FleetRunner(tm, adc_sigma=0.05, adc_seed=0,
                                 **kw).process(same)
    quiet, _, _ = tfleet.FleetRunner(tm, **kw).process(same)
    np.testing.assert_array_equal(quiet[0], quiet[1])
    assert not np.array_equal(s[0], s[1])
    # fleet 0's stream 1 and fleet 1's stream 0 are keyed apart
    seeds = {tfleet.stream_seed(a, b) for a in range(16) for b in range(16)}
    assert len(seeds) == 256
    assert all(0 <= x < 2 ** 32 for x in seeds)
    assert tfleet.stream_seed(0, 1) != tfleet.stream_seed(1, 0)
    assert tfleet.stream_seed(2 ** 40 + 1, 0) != tfleet.stream_seed(1, 0)
    assert tfleet.stream_seed(-1, 3) == tfleet.stream_seed(2 ** 64 - 1, 3)
    # and a runner's seed reaches its noise on the CPU's generators, which
    # keep 32 bits of a seed
    one, other = (tstream.StreamRunner(tm, adc_sigma=0.05, adc_seed=seed,
                                       **kw).process(fr[0])[0]
                  for seed in (0, 1))
    assert not np.array_equal(one, other)


def test_per_stream_classifiers_installed_before_the_first_chunk():
    """``set_class_hvs((S, 2, D))`` in per-stream scope: stream s runs as a
    one-stream runner holding classifier s."""
    _, tm, fr, labels = scenario_models("int8", 200, seed=130)
    _, tkw = runner_kwargs("int8", "adapt")
    rng = np.random.default_rng(131)
    stack = (tm.class_hvs.numpy()[None]
             * rng.uniform(0.8, 1.2, (S, 2, 1)).astype(np.float32))
    f = tfleet.FleetRunner(tm, ControllerConfig(**CTRL), **tkw)
    f.set_class_hvs(stack)
    assert torch.equal(f.class_hvs, t(stack))
    scores, _, _ = f.process(fr, labels=labels)
    for s in range(S):
        r = tstream.StreamRunner(tm, ControllerConfig(**CTRL),
                                 **dict(tkw, adapt=AdaptConfig(lr=0.5)))
        r.set_class_hvs(stack[s])
        np.testing.assert_array_equal(scores[s],
                                      r.process(fr[s], labels=labels[s])[0])
        assert torch.equal(f.class_hvs[s], r.class_hvs)
    # a (2, D) classifier mid-stream goes to every stream
    f.set_class_hvs(stack[0])
    assert torch.equal(f.class_hvs, t(np.stack([stack[0]] * S)))


def test_fleet_validation_and_drain_shape():
    _, tm, fr, labels = scenario_models("int8", 200, seed=140)
    kw = dict(chunk_size=CHUNK, block_d=BLOCK_D, device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        tfleet.FleetRunner(tm, chunk_size=0, device="cpu")
    with pytest.raises(ValueError, match="without adc_bits"):
        tfleet.FleetRunner(tm, adc_sigma=0.1, device="cpu")
    r = tfleet.FleetRunner(tm, **kw)
    with pytest.raises(ValueError, match=r"\(S, n, H, W\)"):
        r.process(fr[0])
    r.process(fr)
    assert r.holds.shape == (S,)
    with pytest.raises(ValueError, match="fleet size changed"):
        r.process(fr[:2])
    with pytest.raises(ValueError, match="per-stream"):
        r.set_class_hvs(np.stack([tm.class_hvs.numpy()] * S))
    with pytest.raises(ValueError, match="labels"):
        tfleet.FleetRunner(tm, adapt=AdaptConfig(), **kw).process(fr)
    with pytest.raises(ValueError, match="labels shape"):
        tfleet.FleetRunner(tm, adapt=AdaptConfig(), **kw).process(
            fr, labels=labels[:, :5])
    per = tfleet.FleetRunner(tm, adapt=AdaptConfig(scope="per-stream"), **kw)
    per.process(fr, labels=labels)
    with pytest.raises(ValueError, match="carried state"):
        per.set_class_hvs(np.zeros((S + 1, 2, 200), np.float32))
    codes = tadc.quantize_codes(t(fr), 8)
    with pytest.raises(ValueError, match="raw frames"):
        tfleet.FleetRunner(tm, adc_bits=8, precision="int8",
                           control=CaptureConfig(), **kw).process(codes)
    r = tfleet.FleetRunner(tm, adc_bits=8, precision="int8",
                           control=CaptureConfig(hp_buffer=0), **kw)
    r.process(codes)
    drains = r.drain_hp()
    assert len(drains) == S
    assert all(i.shape == (0,) and hp.shape == (0, *fr.shape[2:])
               for i, hp in drains)


def test_fleet_runner_needs_a_card_by_default(monkeypatch):
    _, tm = models(150, 200)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet.FleetRunner(tm)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet.simulate_fleet(tm, np.zeros((2, 4, 32, 32), np.float32),
                              np.zeros((2, 4), np.int32))
