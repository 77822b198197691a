"""PyTorch port, the serving layer: the JAX ``FleetService`` (Pallas kernels
in interpret mode) against the port's ``FleetService(device="cpu")`` under
one churn schedule — attach, detach, ragged arrival, a silent tick, a
sensor reattached through another tenant of its slot — noise-free, for
float32 and int8, open loop, closed loop and per-stream pseudo
adaptation, and a JAX checkpoint resumed by the port. Scores agree within
``SCORE_ATOL`` (every score sits more than ``DECISION_MARGIN`` from
``t_score``), decisions, capture logs, HP drains and ``hp_dropped``
exactly, classifiers within 1e-5.

Then the port's own contracts, bitwise (the reference's
``tests/test_serve.py``): a churn-free service equals ``FleetRunner``; any
churn schedule equals independent ``StreamRunner``s (ADC noise included,
keyed by the sensor's uid); detach -> reattach; no rebuilds under churn;
checkpoint kill-and-resume; ``ckpt_every``; the guards; pipelining depth;
the slot pool; tensor arrivals; the no-card default; and the split of
``super_chunk_fn`` into its device and host halves, held against the
function as it was before the split."""

import os

try:  # prefer the real library when installed (requirements-dev.txt)
    import hypothesis
    import hypothesis.strategies as st
except ImportError:  # fallback keeps these tests running without the dep
    from _hypothesis_fallback import hypothesis, st
import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from _torch_parity import (SCORE_ATOL, assert_margin, frames, models,
                           pick_threshold, t)
from repro.core.online import AdaptConfig as JAdapt
from repro.core.sensor_control import CaptureConfig as JCapture
from repro.core.sensor_control import ControllerConfig as JController
from repro.launch import serve as jserve
from repro_torch.core import hypersense as ths
from repro_torch.core import online
from repro_torch.core.hypersense import frame_detection_score
from repro_torch.core.online import AdaptConfig
from repro_torch.core.sensor_control import CaptureConfig, ControllerConfig
from repro_torch.kernels import ops
from repro_torch.analysis import sanitize
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import FleetService
from repro_torch.sensing import adc as tadc
from repro_torch.sensing import fleet as tfleet
from repro_torch.sensing import stream as tstream
from repro_torch.sensing.stream import StreamState

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

C, D, BLOCK_D, N_SENSORS, N_SLOTS = 4, 128, 128, 5, 3
BITS = {"float32": 4, "int8": 8}
CTRL = dict(hold_frames=2, base_rate_hz=10.0, active_rate_hz=30.0)

#: (detach, attach, arrivals) per tick: slot 1 goes 1 -> 3 -> 1 (sensor 1
#: reattached through tenant 3), tick 2 is silent, arrivals are ragged
SCHEDULE = [((), (0, 1, 2), (0, 1, 2)),
            ((1,), (3,), (0, 3)),
            ((), (), ()),
            ((3,), (1,), (0, 1, 2)),
            ((0,), (4,), (1, 4)),
            ((), (), (1, 2, 4))]


def streams(seed):
    """``(N_SENSORS, n, 32, 32)`` frames: each sensor its own draw, enough
    for every tick of the schedule."""
    return np.stack([frames(seed + s, len(SCHEDULE) * C)[0]
                     for s in range(N_SENSORS)])


def play(svc, trace, ticks, fed=None):
    """Run ``ticks`` of SCHEDULE; returns ``{sid: [(s, f, g), ...]}`` and
    the frames fed per sensor."""
    fed = {} if fed is None else fed
    for det, att, arrive in ticks:
        for sid in det:
            svc.detach(sid)
        for sid in att:
            svc.attach(sid)
        arrivals = {}
        for sid in arrive:
            n0 = fed.get(sid, 0)
            arrivals[sid] = trace[sid, n0:n0 + C]
            fed[sid] = n0 + C
        svc.dispatch(arrivals)
    got = {}
    for ch in svc.flush():
        for sid, out in ch.outputs.items():
            got.setdefault(sid, []).append(out)
    return got, fed


def cat(got_sid):
    return [np.concatenate([o[j] for o in got_sid]) for j in range(3)]


def scenario(precision, loop, seed=60):
    """Both models with ``t_score`` in a wide gap of the frozen scores of
    the schedule's frames, the frames, and each package's service
    arguments."""
    trace = streams(seed + 1)
    _, tm = models(seed, D)
    flat = t(trace.reshape(-1, *trace.shape[2:]))
    view = (tadc.quantize(flat, BITS[precision]) if precision == "float32"
            else flat)
    s = ths.frame_scores_batch(tm, view, precision=precision,
                               adc_bits=BITS[precision])
    q = (0.6, 0.9) if loop == "closed" else (0.25, 0.75)
    jm, tm = models(seed, D, t_score=pick_threshold(s.numpy(), *q))
    kw = dict(n_slots=N_SLOTS, chunk_size=C, block_d=BLOCK_D,
              adc_bits=BITS[precision], precision=precision)
    jkw, tkw = dict(kw, backend="pallas"), dict(kw, device="cpu")
    if loop == "closed":
        jkw["control"] = JCapture(hp_bits=12, hp_buffer=2)
        tkw["control"] = CaptureConfig(hp_bits=12, hp_buffer=2)
    if loop == "adapt":
        jkw["adapt"] = JAdapt(mode="pseudo", scope="per-stream", lr=0.3)
        tkw["adapt"] = AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3)
    return jm, tm, trace, jkw, tkw


def assert_services_agree(jsvc, tsvc, jgot, tgot, sids, hp_dropped=True):
    assert set(jgot) == set(tgot)
    for sid in jgot:
        js, jf, jg = cat(jgot[sid])
        ts, tf, tg = cat(tgot[sid])
        np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_ATOL)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tg, jg)
    for sid in sids:
        jlog, tlog = jsvc.capture_log(sid), tsvc.capture_log(sid)
        np.testing.assert_array_equal(tlog.sampled, jlog.sampled)
        np.testing.assert_array_equal(tlog.gated, jlog.gated)
        jidx, jhp = jsvc.drain_hp(sid)
        tidx, thp = tsvc.drain_hp(sid)
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(thp, jhp)
        np.testing.assert_allclose(tsvc.class_hvs_of(sid).numpy(),
                                   jsvc.class_hvs_of(sid), rtol=0,
                                   atol=1e-5)
    if hp_dropped:
        assert tsvc.hp_dropped == jsvc.hp_dropped


PARITY = [(p, loop) for p in BITS for loop in ("open", "closed", "adapt")]


@pytest.mark.parametrize("precision,loop", PARITY)
def test_service_matches_jax_under_churn(precision, loop):
    jm, tm, trace, jkw, tkw = scenario(precision, loop)
    jsvc = jserve.FleetService(jm, JController(**CTRL), **jkw)
    tsvc = FleetService(tm, ControllerConfig(**CTRL), **tkw)
    jgot, _ = play(jsvc, trace, SCHEDULE)
    tgot, _ = play(tsvc, trace, SCHEDULE)
    for sid in jgot:
        assert_margin(cat(jgot[sid])[0], jm.t_score)
    fired = np.concatenate([cat(g)[1] for g in tgot.values()])
    assert 0 < fired.sum() < fired.size      # the gate saw both outcomes
    assert tsvc.attached == jsvc.attached == (4, 1, 2)
    assert tsvc.uid(3) == jsvc.uid(3) == 3
    assert_services_agree(jsvc, tsvc, jgot, tgot, range(N_SENSORS))
    if loop == "closed":
        assert tsvc.hp_dropped > 0
    if loop == "adapt":
        moved = tsvc.class_hvs_of(0).numpy() - np.asarray(jm.class_hvs)
        assert np.abs(moved).max() > 0


@pytest.mark.parametrize("precision", list(BITS))
def test_jax_checkpoint_resumes_in_the_port(precision, tmp_path):
    """The JAX service checkpoints after 3 ticks (sensor 1 parked, HP
    frames undrained); the port's fresh service restores that checkpoint
    and its continuation agrees with the JAX continuation."""
    jm, tm, trace, jkw, tkw = scenario(precision, "closed")
    jkw["adapt"] = JAdapt(mode="pseudo", scope="per-stream", lr=0.3)
    tkw["adapt"] = AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3)
    d = os.fspath(tmp_path)
    jsvc = jserve.FleetService(jm, JController(**CTRL), ckpt_dir=d, **jkw)
    _, fed = play(jsvc, trace, SCHEDULE[:3])
    jsvc.checkpoint()
    jsvc.wait_ckpt()
    dropped_at_ckpt = jsvc.hp_dropped
    tsvc = FleetService(tm, ControllerConfig(**CTRL), ckpt_dir=d, **tkw)
    assert tsvc.restore() == 3
    assert tsvc.attached == jsvc.attached == (0, 3, 2)
    jgot, _ = play(jsvc, trace, SCHEDULE[3:], dict(fed))
    tgot, _ = play(tsvc, trace, SCHEDULE[3:], dict(fed))
    assert_services_agree(jsvc, tsvc, jgot, tgot, range(N_SENSORS),
                          hp_dropped=False)
    assert tsvc.hp_dropped == jsvc.hp_dropped - dropped_at_ckpt


# ---------------------------------------------------------------------------
# the port's own contracts, bitwise
# ---------------------------------------------------------------------------

def port_model(seed=70, D=96):
    _, tm = models(seed, D, t_score=0.0, t_detection=2)
    trace = streams(seed + 1)
    s = ths.frame_scores_batch(tm, t(trace.reshape(-1, 32, 32)))
    _, tm = models(seed, D, t_score=pick_threshold(s.numpy()),
                   t_detection=2)
    return tm, trace


CFG = ControllerConfig(hold_frames=2)


def drain(svc, got):
    for ch in svc.flush():
        for sid, out in ch.outputs.items():
            got.setdefault(sid, []).append(out)


@pytest.mark.parametrize("kw", [
    {},
    {"adc_bits": 5, "adc_sigma": 0.02},
    {"adapt": AdaptConfig(mode="pseudo", scope="shared", lr=0.3)},
    {"control": CaptureConfig(hp_bits=12, hp_buffer=2)},
    {"precision": "int4", "adc_bits": 4,
     "adapt": AdaptConfig(mode="label", scope="per-stream", lr=0.5)},
], ids=["frozen", "adc-noise", "adapt-shared", "closed-loop",
        "int4-label-per-stream"])
def test_churn_free_bitwise_vs_fleet_runner(kw):
    model, trace = port_model()
    S, T = 3, 4
    labels = (np.arange(T * C)[None, :] // 3 + np.arange(S)[:, None]) % 2
    feed = labels if kw.get("adapt") and kw["adapt"].mode == "label" \
        else None
    runner = tfleet.FleetRunner(model, CFG, chunk_size=C, block_d=64,
                                device="cpu", **kw)
    s_ref, f_ref, g_ref = runner.process(trace[:S, :T * C], labels=feed)
    svc = FleetService(model, CFG, n_slots=S, chunk_size=C, block_d=64,
                       device="cpu", **kw)
    for i in range(S):
        svc.attach(i)
    got = {}
    for k in range(T):
        sl = slice(k * C, (k + 1) * C)
        svc.dispatch({i: trace[i, sl] for i in range(S)},
                     labels=None if feed is None
                     else {i: feed[i, sl] for i in range(S)})
    drain(svc, got)
    assert 0 < f_ref.sum() < f_ref.size
    for i in range(S):
        s, f, g = cat(got[i])
        np.testing.assert_array_equal(s, s_ref[i])
        np.testing.assert_array_equal(f, f_ref[i])
        np.testing.assert_array_equal(g, g_ref[i])
        log = svc.capture_log(i)
        np.testing.assert_array_equal(log.sampled,
                                      runner.capture_log.sampled[i])
        np.testing.assert_array_equal(log.gated, runner.capture_log.gated[i])
        chvs = runner.class_hvs
        assert torch.equal(svc.class_hvs_of(i),
                           chvs[i] if chvs.ndim == 3 else chvs)
    if "control" in kw:
        ref_hp = runner.drain_hp()
        for i in range(S):
            idx, hp = svc.drain_hp(i)
            np.testing.assert_array_equal(idx, ref_hp[i][0])
            np.testing.assert_array_equal(hp, ref_hp[i][1])
        assert svc.hp_dropped == runner.hp_dropped > 0


@hypothesis.given(st.integers(0, 2 ** 31 - 1), st.booleans())
@hypothesis.settings(max_examples=4, deadline=None)
def test_any_churn_schedule_matches_independent_runners(seed, adapt_on):
    """Random attach/detach/silence: every sensor's outputs, capture log
    and (adapting) classifier are bitwise an independent StreamRunner's
    over its own frames, its noise keyed by its uid."""
    model, trace = port_model()
    rng = np.random.default_rng(seed)
    T = len(SCHEDULE)
    adapt = (AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3)
             if adapt_on else None)
    kw = dict(chunk_size=C, adc_bits=5, adc_sigma=0.02, adc_seed=seed % 97,
              device="cpu")
    svc = FleetService(model, CFG, n_slots=N_SLOTS, adapt=adapt, **kw)
    attached, fed, got, warm = set(), {}, {}, False
    for _ in range(T):
        if attached and rng.random() < 0.3:
            gone = int(rng.choice(sorted(attached)))
            svc.detach(gone)
            attached.discard(gone)
        if svc.free_slots and rng.random() < 0.7:
            cand = [i for i in range(N_SENSORS) if i not in attached]
            sid = int(rng.choice(cand))
            svc.attach(sid)
            attached.add(sid)
        arrivals = {}
        for sid in sorted(attached):
            if rng.random() < 0.8:
                n0 = fed.setdefault(sid, 0)
                arrivals[sid] = trace[sid, n0:n0 + C]
                fed[sid] = n0 + C
        if not arrivals and not warm:
            continue
        warm = True
        svc.dispatch(arrivals)
    drain(svc, got)
    for sid, n in fed.items():
        ref = tstream.StreamRunner(
            model, CFG, adapt=(AdaptConfig(mode="pseudo", lr=0.3)
                               if adapt_on else None),
            **dict(kw, adc_seed=tfleet.stream_seed(kw["adc_seed"],
                                                   svc.uid(sid))))
        for a, b in zip(cat(got[sid]), ref.process(trace[sid, :n])):
            np.testing.assert_array_equal(a, b)
        log = svc.capture_log(sid)
        np.testing.assert_array_equal(log.sampled, ref.capture_log.sampled)
        np.testing.assert_array_equal(log.gated, ref.capture_log.gated)
        if adapt_on:
            assert torch.equal(svc.class_hvs_of(sid), ref.class_hvs)


def test_detach_reattach_restores_adapted_classifier_exactly():
    model, trace = port_model()
    adapt = AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3)
    svc = FleetService(model, CFG, n_slots=1, chunk_size=C, adapt=adapt,
                       device="cpu")
    svc.attach("a")
    svc.dispatch({"a": trace[0, 0:C]})
    svc.dispatch({"a": trace[0, C:2 * C]})
    chvs_a = svc.class_hvs_of("a")
    assert not torch.equal(chvs_a, model.class_hvs), \
        "sanity: adaptation must have moved the classifier"
    svc.detach("a")
    assert torch.equal(svc.class_hvs_of("a"), chvs_a)
    svc.attach("b")                       # another tenant adapts the slot
    svc.dispatch({"b": trace[1, 0:C]})
    svc.detach("b")
    svc.attach("a")
    assert torch.equal(svc.class_hvs_of("a"), chvs_a)
    svc.dispatch({"a": trace[0, 2 * C:3 * C]})
    ref = tstream.StreamRunner(model, CFG, chunk_size=C, device="cpu",
                               adapt=AdaptConfig(mode="pseudo", lr=0.3))
    ref.process(trace[0, :3 * C])
    assert torch.equal(svc.class_hvs_of("a"), ref.class_hvs)


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_churn_never_rebuilds(precision):
    model, trace = port_model()
    svc = FleetService(model, CFG, n_slots=2, chunk_size=C, adc_bits=8,
                       precision=precision, device="cpu",
                       adapt=AdaptConfig(mode="pseudo", scope="per-stream"))
    svc.attach(0)
    svc.dispatch({0: trace[0, 0:C]})      # warm-up builds everything
    svc.flush()
    c0 = svc.rebuild_count()
    assert c0 > 0
    svc.attach(1)
    svc.dispatch({0: trace[0, C:2 * C], 1: trace[1, 0:C]})
    svc.detach(0)
    svc.dispatch({1: trace[1, C:2 * C]})
    svc.dispatch({})                      # fully silent tick
    svc.attach(2)
    svc.dispatch({2: trace[2, 0:C]})
    svc.flush()
    assert svc.rebuild_count() == c0


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_checkpoint_kill_and_resume_bitwise(precision, tmp_path):
    """Outputs, logs, adapted classifiers, parked sensors and undrained HP
    frames continue bitwise after a restore into a fresh service."""
    model, trace = port_model()
    cfg = ControllerConfig(**CTRL)
    td = os.fspath(tmp_path)

    def build():
        return FleetService(
            model, cfg, n_slots=2, chunk_size=C, block_d=64,
            adapt=AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3),
            adc_bits=5, adc_sigma=0.02, precision=precision,
            control=CaptureConfig(hp_bits=12, hp_buffer=2), ckpt_dir=td,
            device="cpu")

    svc = build()
    svc.attach("x")
    svc.attach("y")
    svc.dispatch({"x": trace[0, 0:C], "y": trace[1, 0:C]})
    svc.detach("y")                       # parked at snapshot time
    svc.dispatch({"x": trace[0, C:2 * C]})
    svc.dispatch({"x": trace[0, 2 * C:3 * C]})
    svc.flush()
    svc.checkpoint()                      # HP frames undrained
    svc.wait_ckpt()
    assert sum(len(svc._hp[s]) for s in ("x", "y")) > 0

    def continuation(s):
        s.attach("y")
        s.dispatch({"x": trace[0, 3 * C:4 * C], "y": trace[1, C:2 * C]})
        out = {}
        drain(s, out)
        return out

    ref = continuation(svc)
    svc2 = build()
    assert svc2.restore() == 3
    assert svc2.attached == ("x",)
    got = continuation(svc2)
    assert set(ref) == set(got) == {"x", "y"}
    for sid in ref:
        for a, b in zip(cat(ref[sid]), cat(got[sid])):
            np.testing.assert_array_equal(a, b)
    for sid in ("x", "y"):
        assert torch.equal(svc.class_hvs_of(sid), svc2.class_hvs_of(sid))
        la, lb = svc.capture_log(sid), svc2.capture_log(sid)
        np.testing.assert_array_equal(la.sampled, lb.sampled)
        np.testing.assert_array_equal(la.gated, lb.gated)
        for a, b in zip(svc.drain_hp(sid), svc2.drain_hp(sid)):
            np.testing.assert_array_equal(a, b)


def test_ckpt_every_autosnapshots(tmp_path):
    from repro_torch.ckpt import checkpoint as ckpt_mod
    model, trace = port_model()
    svc = FleetService(model, CFG, n_slots=1, chunk_size=C, device="cpu",
                       ckpt_dir=os.fspath(tmp_path), ckpt_every=2)
    svc.attach(0)
    for k in range(4):
        svc.dispatch({0: trace[0, k * C:(k + 1) * C]})
    svc.flush()
    svc.wait_ckpt()
    assert ckpt_mod.latest_step(os.fspath(tmp_path)) == 4


def test_restore_guards(tmp_path):
    model, trace = port_model()
    td = os.fspath(tmp_path)
    svc = FleetService(model, CFG, n_slots=1, chunk_size=C, device="cpu",
                       ckpt_dir=td)
    svc.attach(0)
    svc.dispatch({0: trace[0, :C]})
    svc.checkpoint()
    svc.wait_ckpt()
    with pytest.raises(RuntimeError, match="freshly constructed"):
        svc.restore()
    with pytest.raises(ValueError, match="n_slots"):
        FleetService(model, CFG, n_slots=5, chunk_size=C, device="cpu",
                     ckpt_dir=td).restore()
    with pytest.raises(ValueError, match="precision"):
        FleetService(model, CFG, n_slots=1, chunk_size=C, device="cpu",
                     precision="int8", adc_bits=8, ckpt_dir=td).restore()
    with pytest.raises(ValueError, match="class_hvs"):
        FleetService(model, CFG, n_slots=1, chunk_size=C, device="cpu",
                     adapt=AdaptConfig(scope="per-stream"),
                     ckpt_dir=td).restore()
    with pytest.raises(RuntimeError, match="ckpt_dir"):
        FleetService(model, CFG, n_slots=1, chunk_size=C,
                     device="cpu").checkpoint()
    with pytest.raises(ValueError, match="ckpt_dir"):
        FleetService(model, CFG, n_slots=1, chunk_size=C, ckpt_every=2,
                     device="cpu")


@pytest.mark.parametrize("inflight", [1, 2, 4])
def test_max_inflight_is_invisible_to_results(inflight):
    model, trace = port_model()
    S, T = 2, 5
    outs = []
    for depth in (2, inflight):
        svc = FleetService(model, CFG, n_slots=S, chunk_size=C,
                           max_inflight=depth, adc_bits=5,
                           control=CaptureConfig(hp_bits=12, hp_buffer=1),
                           device="cpu")
        for i in range(S):
            svc.attach(i)
        seqs, got = [], {}
        for k in range(T):
            svc.dispatch({i: trace[i, k * C:(k + 1) * C] for i in range(S)})
            assert len(svc._pending) <= depth
        for ch in svc.flush():
            seqs.append(ch.seq)
            for sid, out in ch.outputs.items():
                got.setdefault(sid, []).append(out)
        assert seqs == list(range(T)), "collect must be FIFO"
        assert svc.collect() is None      # drained
        outs.append((got, [svc.drain_hp(i) for i in range(S)]))
    for i in range(S):
        for a, b in zip(cat(outs[0][0][i]), cat(outs[1][0][i])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(outs[0][1][i], outs[1][1][i]):
            np.testing.assert_array_equal(a, b)


def test_slot_pool_errors():
    model, trace = port_model()
    svc = FleetService(model, CFG, n_slots=1, chunk_size=C, device="cpu")
    with pytest.raises(ValueError, match="at least one arrival"):
        svc.dispatch({})
    svc.attach("a")
    with pytest.raises(ValueError, match="already attached"):
        svc.attach("a")
    with pytest.raises(RuntimeError, match="exhausted"):
        svc.attach("b")
    with pytest.raises(ValueError, match="not attached"):
        svc.detach("b")
    with pytest.raises(TypeError, match="str or int"):
        svc.attach(("tuple", "sid"))
    with pytest.raises(ValueError, match="not attached"):
        svc.dispatch({"b": trace[0, :C]})
    with pytest.raises(ValueError, match="expected"):
        svc.dispatch({"a": trace[0, :C + 1]})
    with pytest.raises(ValueError, match="labels"):
        svc.dispatch({"a": trace[0, :C]}, labels={"a": np.zeros(C, int)})
    with pytest.raises(ValueError, match="n_slots"):
        FleetService(model, CFG, n_slots=0, chunk_size=C, device="cpu")
    with pytest.raises(ValueError, match="max_inflight"):
        FleetService(model, CFG, n_slots=1, chunk_size=C, max_inflight=0,
                     device="cpu")
    lab = FleetService(model, CFG, n_slots=1, chunk_size=C, device="cpu",
                       adapt=AdaptConfig(mode="label"))
    lab.attach("a")
    with pytest.raises(ValueError, match="needs labels"):
        lab.dispatch({"a": trace[0, :C]})
    codes = FleetService(model, CFG, n_slots=1, chunk_size=C, device="cpu",
                         precision="int8", adc_bits=4)
    codes.attach("a")
    with pytest.raises(ValueError, match=r"codes in \[16, 16\]"):
        codes.dispatch({"a": np.full((C, 32, 32), 16, np.int32)})


def test_detach_frees_capacity_for_new_tenant():
    model, trace = port_model()
    svc = FleetService(model, CFG, n_slots=1, chunk_size=C, device="cpu")
    svc.attach("a")
    svc.dispatch({"a": trace[0, 0:C]})
    svc.detach("a")
    assert svc.free_slots == 1
    svc.attach("b")                       # reuses the slot
    svc.dispatch({"b": trace[1, 0:C]})
    got = {}
    drain(svc, got)
    ref = tstream.StreamRunner(model, CFG, chunk_size=C, device="cpu")
    s_ref, _, g_ref = ref.process(trace[1, 0:C])
    np.testing.assert_array_equal(cat(got["b"])[0], s_ref)
    np.testing.assert_array_equal(cat(got["b"])[2], g_ref)
    assert svc.uid("a") != svc.uid("b")   # a's uid persists while parked


def test_tensor_arrivals_bitwise_match_numpy_arrivals():
    """Tensor and numpy arrivals of the same frames or integer codes give
    the same bits; integer codes skip the converter."""
    model, trace = port_model()
    codes = np.clip(np.abs(trace[0, :2 * C]) * 8, 0, 31).astype(np.int32)

    def play_codes(arrival_of):
        svc = FleetService(model, CFG, n_slots=1, chunk_size=C,
                           precision="int8", adc_bits=5, device="cpu")
        svc.attach(0)
        for k in range(2):
            svc.dispatch({0: arrival_of(codes[k * C:(k + 1) * C])})
        got = {}
        drain(svc, got)
        return cat(got[0])

    host = play_codes(lambda a: a)
    for a, b in zip(host, play_codes(torch.from_numpy)):
        np.testing.assert_array_equal(a, b)
    runner = tstream.StreamRunner(model, CFG, chunk_size=C, precision="int8",
                                  adc_bits=5, device="cpu")
    for a, b in zip(host, runner.process(codes)):
        np.testing.assert_array_equal(a, b)


class _HostReads(TorchFunctionMode):
    """Every implicit host read of a tensor (``sanitize``'s list: ``item``,
    ``tolist``, ``numpy``, ``bool``, ``int``, ...) made inside the block."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in sanitize._IMPLICIT:
            self.reads.append(sanitize._IMPLICIT[func])
        return func(*args, **(kwargs or {}))


def test_card_codes_are_range_checked_with_one_read(monkeypatch):
    """Integer codes arriving on the card at every slot are range-checked
    together: a warm tick of three card arrivals makes exactly one host
    read (the fused min/max, as the reference's one check of its assembled
    tick), not one a sensor. The bits equal host (numpy) arrivals of the
    same codes, and a bad code on any sensor raises before anything is
    copied, an int64 code past int32's range (which the tick's int32 copy
    would wrap into range) too."""
    model, trace = port_model()
    codes = np.clip(np.abs(trace[:3, :2 * C]) * 8, 0, 31).astype(np.int32)

    def service():
        svc = FleetService(model, CFG, n_slots=3, chunk_size=C,
                           precision="int8", adc_bits=5, max_inflight=4,
                           device="cpu")
        for s in range(3):
            svc.attach(s)
        return svc

    def tick(k, arrival_of):
        return {s: arrival_of(codes[s, k * C:(k + 1) * C]) for s in range(3)}

    host = service()
    for k in range(2):
        host.dispatch(tick(k, lambda a: a))
    want = {}
    drain(host, want)

    # on the CPU, tensors stand in for arrivals on the card
    monkeypatch.setattr(tserve, "_on_card",
                        lambda fr: isinstance(fr, torch.Tensor))
    svc = service()
    svc.dispatch(tick(0, torch.from_numpy))
    with _HostReads() as counted:
        svc.dispatch(tick(1, torch.from_numpy))
    assert counted.reads == ["tolist()"], counted.reads
    got = {}
    drain(svc, got)
    for s in range(3):
        for a, b in zip(cat(got[s]), cat(want[s])):
            np.testing.assert_array_equal(a, b)

    for bad, dtype in ((32, torch.int32), (-1, torch.int32),
                       (2 ** 32 + 3, torch.int64)):
        arrivals = tick(0, lambda a: torch.from_numpy(a).to(dtype))
        arrivals[2][1, 0, 0] = bad
        with pytest.raises(ValueError, match="5-bit range"):
            service().dispatch(arrivals)


def test_the_default_device_needs_a_card(monkeypatch):
    model, _ = port_model()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        FleetService(model, CFG, n_slots=1)


# ---------------------------------------------------------------------------
# the split of super_chunk_fn is invisible
# ---------------------------------------------------------------------------

def _collect_hp_before(raw_chunk, gated, n_valid, k, bits, base):
    """``stream.collect_hp`` before the split: ``hp_capture`` per stream."""
    S = raw_chunk.shape[0]
    base = np.broadcast_to(np.asarray(base, np.int64), (S,))
    out, dropped = [], 0
    for si in range(S):
        buf, idx, cnt = tstream.hp_capture(raw_chunk[si], gated[si], n_valid,
                                           k, bits)
        idx, buf = idx.cpu().numpy(), buf.cpu().numpy()
        kept = idx >= 0
        out.append(list(zip((base[si] + idx[kept]).tolist(), buf[kept])))
        dropped += max(int(cnt) - int(kept.sum()), 0)
    return out, dropped


def _super_chunk_before(frames, state, B0, b, tiles, t_score, n_valid, labels,
                        slot_mask=None, *, h, w, stride, nonlinearity,
                        t_detection, hold_frames, adapt=None,
                        precision="float32", adc_lsb=1.0, decim=None,
                        park_masked=False):
    """``stream.super_chunk_fn`` as it was before the split, in one piece."""
    S, C, H, W = frames.shape
    my, mx = (H - h) // stride + 1, (W - w) // stride + 1
    class_hvs = state.class_hvs
    per_stream = adapt is not None and adapt.scope == "per-stream"
    kw = dict(h=h, w=w, stride=stride, nonlinearity=nonlinearity)
    if precision in tadc.INT_PRECISIONS:
        ktiles = (tiles if adapt is None else
                  ops.retile_classes_int_fleet(tiles, class_hvs) if per_stream
                  else ops.retile_classes_int(tiles, class_hvs))
        packed = precision == "int4"
        maps = ops.fragment_score_map_fleet_int(
            tadc.pack_nibbles(frames) if packed else frames, class_hvs, B0,
            b, tiles=ktiles, packed=packed, **kw)
    else:
        ktiles = (tiles if adapt is None else
                  ops.retile_classes_fleet(tiles, class_hvs) if per_stream
                  else ops.retile_classes(tiles, class_hvs))
        maps = ops.fragment_score_map_fleet(frames, class_hvs, B0, b,
                                            tiles=ktiles, **kw)
    scores = frame_detection_score(maps, t_detection).cpu()
    valid = torch.arange(C) < n_valid
    if t_detection >= my * mx:
        fired = torch.zeros((S, C), dtype=torch.bool)
    else:
        fired = (scores > t_score) & valid[None, :]
    if slot_mask is not None:
        slot_mask = slot_mask.cpu()
        fired = fired & slot_mask[:, None]
    last = max(n_valid - 1, 0)
    if decim is None:
        sampled = valid[None, :].expand(S, C)
        if slot_mask is not None:
            sampled = sampled & slot_mask[:, None]
        scans = [tstream.gate_scan(fired[s], hold_frames, state.holds[s])
                 for s in range(S)]
        gated = torch.stack([g for g, _ in scans])
        holds_seq = torch.stack([hs for _, hs in scans])
        phase_out = state.phases
    else:
        scans = [tstream.control_scan(fired[s], hold_frames, decim,
                                      state.holds[s], state.phases[s])
                 for s in range(S)]
        sampled, gated, holds_seq, phases_seq = (
            torch.stack(x) for x in zip(*scans))
        fired = fired & sampled
        if slot_mask is not None:
            sampled = sampled & slot_mask[:, None]
        phase_out = phases_seq[:, last] if n_valid > 0 else state.phases
    hold_out = holds_seq[:, last] if n_valid > 0 else state.holds
    if adapt is not None:
        obs = (frames.to(torch.float32) * adc_lsb
               if precision in tadc.INT_PRECISIONS else frames)
        hvs = tstream._top_fragment_hvs(obs, maps, B0, b, mx=mx, h=h, w=w,
                                        stride=stride,
                                        nonlinearity=nonlinearity)
        labels = labels.to(class_hvs.device, torch.int64)
        if decim is None:
            mask2d = valid[None, :].expand(S, C)
            if slot_mask is not None:
                mask2d = mask2d & slot_mask[:, None]
        else:
            mask2d = sampled & valid[None, :]
        if per_stream:
            class_hvs = torch.stack([
                online.apply_chunk(adapt, class_hvs[s].clone(), hvs[s],
                                   labels[s], mask2d[s])[0]
                for s in range(S)])
        else:
            dim = hvs[0].shape[-1]
            class_hvs = online.apply_chunk(
                adapt, class_hvs, torch.stack(hvs, 1).reshape(C * S, dim),
                labels.T.reshape(C * S), mask2d.T.reshape(C * S))[0]
    if park_masked and slot_mask is not None:
        hold_out = torch.where(slot_mask, hold_out, state.holds)
        phase_out = torch.where(slot_mask, phase_out, state.phases)
        if class_hvs.ndim == 3:
            class_hvs = torch.where(slot_mask[:, None, None], class_hvs,
                                    state.class_hvs)
    return scores, fired, gated, sampled, StreamState(
        class_hvs=class_hvs, holds=hold_out, phases=phase_out,
        frame_idx=state.frame_idx + n_valid)


SPLIT = [("float32", "closed", "per-stream"), ("int8", "open", "shared"),
         ("int4", "closed", None), ("binary", "open", "per-stream")]


@pytest.mark.parametrize("precision,loop,scope", SPLIT)
def test_split_is_invisible_to_the_runners(precision, loop, scope,
                                           monkeypatch):
    """``StreamRunner`` and ``FleetRunner`` give the bits of the function
    before the split, padded tail chunk included."""
    model, trace = port_model()
    bits = {"float32": 4, "int4": 4}.get(precision, 8)
    kw = dict(chunk_size=C, block_d=64, adc_bits=bits, precision=precision,
              device="cpu",
              control=(CaptureConfig(hp_bits=12, hp_buffer=1)
                       if loop == "closed" else None))
    cfg = ControllerConfig(**CTRL)
    fr, n = trace[:3, :3 * C + 2], 3 * C + 2
    labels = (np.arange(n)[None, :] // 3 + np.arange(3)[:, None]) % 2

    def runs():
        fleet = tfleet.FleetRunner(
            model, cfg, adapt=None if scope is None
            else AdaptConfig(mode="label", lr=0.5, scope=scope), **kw)
        one = tstream.StreamRunner(
            model, cfg, adapt=None if scope is None
            else AdaptConfig(mode="label", lr=0.5), **kw)
        feed = None if scope is None else labels
        out = [fleet.process(fr, labels=feed),
               one.process(fr[0], labels=None if feed is None else feed[0])]
        return out, [fleet.class_hvs, one.class_hvs], [
            fleet.capture_log, one.capture_log], [
            fleet.drain_hp(), one.drain_hp()], fleet.hp_dropped

    after = runs()
    monkeypatch.setattr(tstream, "super_chunk_fn", _super_chunk_before)
    monkeypatch.setattr(tfleet, "super_chunk_fn", _super_chunk_before)
    monkeypatch.setattr(tstream, "collect_hp", _collect_hp_before)
    before = runs()
    for a, b in zip(after[0], before[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(after[1], before[1]):
        assert torch.equal(a, b)
    for a, b in zip(after[2], before[2]):
        np.testing.assert_array_equal(a.sampled, b.sampled)
        np.testing.assert_array_equal(a.gated, b.gated)
    drains_after = after[3][0] + [after[3][1]]
    drains_before = before[3][0] + [before[3][1]]
    for (ia, fa), (ib, fb) in zip(drains_after, drains_before):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(fa, fb)
    assert after[4] == before[4]
    if loop == "closed":
        assert sum(len(i) for i, _ in drains_after) > 0
