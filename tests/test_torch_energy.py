"""PyTorch port, the energy account: every function of the port's
``core/energy.py`` against the JAX package's on the same arguments (the
same float, field for field), ``calibrate`` within 1e-9, and
``fleet_report`` / ``simulate_fleet`` against the reference's on the same
``(S, n)`` decisions and labels."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import frames, models, pick_threshold, t
from repro.core import energy as jenergy
from repro.core.sensor_control import CaptureConfig as JCapture
from repro.core.sensor_control import CaptureLog as JCaptureLog
from repro.core.sensor_control import ControllerConfig as JController
from repro.sensing import fleet as jfleet
from repro_torch.core import energy as tenergy
from repro_torch.core import hypersense as ths
from repro_torch.core.sensor_control import (CaptureConfig, CaptureLog,
                                             ControllerConfig)
from repro_torch.sensing import fleet as tfleet

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

PRECISIONS = ("float32", "int8", "int4", "binary")
#: default constants and a non-default set, as both packages take them
PARAMS = ({}, dict(rf_frontend_j=0.3, adc_hp_j=0.4, adc_lp_bits=6,
                   adc_hp_bits=10, hdc_accel_j=0.02, comm_j_per_mbit=1.5,
                   cloud_j=2.0, bdc_ratio=0.4, frame_bits=64 * 64 * 8))


def fields(b) -> dict:
    """An ``EnergyBreakdown`` as its five fields and two sums."""
    return dict(dataclasses.asdict(b), edge=b.edge, total=b.total)


def test_constants_and_defaults_match():
    assert dataclasses.asdict(tenergy.EnergyParams()) == \
        dataclasses.asdict(jenergy.EnergyParams())
    assert tenergy.PAPER_TABLE_III == jenergy.PAPER_TABLE_III
    assert tenergy.EDGE_J_PER_FLOP == jenergy.EDGE_J_PER_FLOP
    for kw in PARAMS:
        tp, jp = tenergy.EnergyParams(**kw), jenergy.EnergyParams(**kw)
        assert (tp.adc_lp_j, tp.comm_j) == (jp.adc_lp_j, jp.comm_j)


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_analytic_accounts_match(kw, precision):
    tp, jp = tenergy.EnergyParams(**kw), jenergy.EnergyParams(**kw)
    assert fields(tenergy.conventional(tp)) == fields(jenergy.conventional(jp))
    assert fields(tenergy.compressive_sensing(tp)) == \
        fields(jenergy.compressive_sensing(jp))
    assert tenergy._hdc_j(tp, precision) == jenergy._hdc_j(jp, precision)
    for fpr, tpr, p in ((0.05, 0.9256, 0.01), (0.3, 0.98, 0.2),
                        (0.0, 1.0, 0.5)):
        assert tenergy.duty_cycle(fpr, tpr, p) == \
            jenergy.duty_cycle(fpr, tpr, p)
        ours = tenergy.hypersense(fpr, tpr, p, tp, precision)
        assert fields(ours) == fields(jenergy.hypersense(fpr, tpr, p, jp,
                                                         precision))
        base = tenergy.conventional(tp)
        assert tenergy.savings(ours, base) == jenergy.savings(
            jenergy.hypersense(fpr, tpr, p, jp, precision),
            jenergy.conventional(jp))
        assert tenergy.quality_loss(tpr) == jenergy.quality_loss(tpr)
    for duty in (0.0, 0.137, 1.0):
        assert fields(tenergy.hypersense_measured(duty, tp, precision)) == \
            fields(jenergy.hypersense_measured(duty, jp, precision))
    for bits in (1, 4, 8, 12, 16):
        assert tenergy.adc_conversion_j(bits, tp) == \
            jenergy.adc_conversion_j(bits, jp)


def test_unknown_precision_raises_alike():
    for mod in (tenergy, jenergy):
        with pytest.raises(ValueError, match="unknown datapath precision"):
            mod._hdc_j(mod.EnergyParams(), "int2")


def _logs(seed, shape, lp_bits, hp_bits):
    rng = np.random.default_rng(seed)
    sampled = rng.random(shape) < 0.7
    gated = sampled & (rng.random(shape) < 0.3)
    return (CaptureLog(sampled, gated, lp_bits, hp_bits, 1024),
            JCaptureLog(sampled, gated, lp_bits, hp_bits, 1024))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("bits", [(None, None), (4, None), (8, 12),
                                  (None, 10)])
def test_capture_log_billing_matches(precision, bits):
    for shape, seed in (((50,), 1), ((4, 30), 2)):
        tlog, jlog = _logs(seed, shape, *bits)
        for kw in PARAMS:
            tp, jp = tenergy.EnergyParams(**kw), jenergy.EnergyParams(**kw)
            assert tenergy._resolve_log_bits(tlog, tp, "params") == \
                jenergy._resolve_log_bits(jlog, jp, "params")
            assert fields(tenergy.from_capture_log(tlog, tp, precision)) == \
                fields(jenergy.from_capture_log(jlog, jp, precision))
            if bits[1] is None:
                for mod, log, p in ((tenergy, tlog, tp), (jenergy, jlog, jp)):
                    with pytest.raises(ValueError, match="hp_bits=None"):
                        mod.from_capture_log(log, p, precision,
                                             on_missing_bits="error")
            else:
                assert fields(tenergy.from_capture_log(
                    tlog, tp, precision, on_missing_bits="error")) == \
                    fields(jenergy.from_capture_log(
                        jlog, jp, precision, on_missing_bits="error"))
    for mod, log in ((tenergy, tlog), (jenergy, jlog)):
        with pytest.raises(ValueError, match="on_missing_bits"):
            mod.from_capture_log(log, on_missing_bits="zero")


def test_open_loop_capture_bill_equals_duty_bill():
    """Every frame sampled and the log's depths the params': the capture
    log bills exactly ``hypersense_measured(duty)``, in both packages."""
    rng = np.random.default_rng(3)
    gated = rng.random((3, 40)) < 0.25
    for lp in (4, 8):
        log = CaptureLog(np.ones_like(gated), gated, lp, None, 1024)
        p = tenergy.EnergyParams(adc_lp_bits=lp)
        for precision in PRECISIONS:
            assert tenergy.from_capture_log(log, p, precision) == \
                tenergy.hypersense_measured(float(gated.mean()), p,
                                            precision)


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_cascade_accounts_match(precision):
    tlog, jlog = _logs(4, (3, 25), 4, 12)
    tb = tenergy.BackboneCost(flops=2.5e9, bytes=1e8,
                              joules=2.5e9 * tenergy.EDGE_J_PER_FLOP)
    jb = jenergy.BackboneCost(flops=2.5e9, bytes=1e8,
                              joules=2.5e9 * jenergy.EDGE_J_PER_FLOP)
    for kw in PARAMS:
        tp, jp = tenergy.EnergyParams(**kw), jenergy.EnergyParams(**kw)
        assert fields(tenergy.cascade_system(tlog, tb, tp, precision)) == \
            fields(jenergy.cascade_system(jlog, jb, jp, precision))
        assert fields(tenergy.always_on_backbone(tb, tp)) == \
            fields(jenergy.always_on_backbone(jb, jp))
    open_t, _ = _logs(4, (3, 25), 4, None)
    with pytest.raises(ValueError, match="hp_bits=None"):
        tenergy.cascade_system(open_t, tb)


def test_calibrate_matches():
    for p_object in (0.01, 0.05):
        got = dataclasses.asdict(tenergy.calibrate(p_object))
        want = dataclasses.asdict(jenergy.calibrate(p_object))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=0)


def _decisions(seed, S=4, n=30, positives=True):
    rng = np.random.default_rng(seed)
    fired = rng.random((S, n)) < 0.2
    gated = fired | (rng.random((S, n)) < 0.1)
    labels = (rng.random((S, n)) < 0.3).astype(np.int32)
    if not positives:
        labels[1] = 0          # a stream with no object frame: NaN rates
    return fired, gated, labels


def _assert_reports_equal(got, want):
    assert (got.n_sensors, got.n_frames) == (want.n_sensors, want.n_frames)
    assert got.duty_cycle == want.duty_cycle
    assert fields(got.energy_per_frame) == fields(want.energy_per_frame)
    assert got.energy_total_j == want.energy_total_j
    assert got.baseline_total_j == want.baseline_total_j
    assert got.total_saving == want.total_saving
    for a, b in zip(got.stats, want.stats):
        np.testing.assert_array_equal(a.decisions, b.decisions)
        np.testing.assert_array_equal(a.gated_on, b.gated_on)
        np.testing.assert_equal((a.duty_cycle, a.missed_positive,
                                 a.false_active),
                                (b.duty_cycle, b.missed_positive,
                                 b.false_active))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("positives", [True, False])
def test_fleet_report_matches(precision, positives):
    fired, gated, labels = _decisions(5, positives=positives)
    tlog, jlog = _logs(6, fired.shape, 4, 12)
    for kw in PARAMS:
        tp, jp = tenergy.EnergyParams(**kw), jenergy.EnergyParams(**kw)
        _assert_reports_equal(
            tfleet.fleet_report(fired, gated, labels, tp, precision),
            jfleet.fleet_report(fired, gated, labels, jp, precision))
        _assert_reports_equal(
            tfleet.fleet_report(fired, gated, labels, tp, precision,
                                capture=tlog),
            jfleet.fleet_report(fired, gated, labels, jp, precision,
                                capture=jlog))
    if not positives:
        assert np.isnan(tfleet.fleet_report(fired, gated,
                                            labels).stats[1].missed_positive)


@pytest.mark.parametrize("precision,closed", [("int8", False),
                                              ("float32", True)])
def test_simulate_fleet_matches(precision, closed):
    """The same fleet through both packages' ``simulate_fleet``: equal
    decisions (every score clear of ``t_score``) give equal reports."""
    bits = 8 if precision == "int8" else 4
    S, n = 3, 20
    fr = np.stack([frames(160 + s, n)[0] for s in range(S)])
    labels = np.stack([frames(160 + s, n)[1] for s in range(S)])
    _, tm = models(170, 200)
    s = ths.frame_scores_batch(tm, t(fr.reshape(-1, 32, 32)),
                               precision=precision, adc_bits=bits)
    jm, tm = models(170, 200, t_score=pick_threshold(
        s.numpy(), *((0.6, 0.9) if closed else (0.25, 0.75))))
    ctrl = dict(hold_frames=2, base_rate_hz=10.0, active_rate_hz=30.0)
    kw = dict(chunk_size=8, block_d=128, adc_bits=bits, precision=precision)
    p = dict(adc_lp_bits=bits)
    got = tfleet.simulate_fleet(
        tm, fr, labels, ControllerConfig(**ctrl), device="cpu",
        control=CaptureConfig(hp_buffer=0) if closed else None,
        energy_params=tenergy.EnergyParams(**p), **kw)
    want = jfleet.simulate_fleet(
        jm, fr, labels, JController(**ctrl), backend="pallas",
        control=JCapture(hp_buffer=0) if closed else None,
        energy_params=jenergy.EnergyParams(**p), **kw)
    _assert_reports_equal(got, want)
    assert 0 < got.duty_cycle < 1 and 0 < got.total_saving < 1
    duty_bill = tfleet.fleet_report(
        np.stack([x.decisions for x in got.stats]),
        np.stack([x.gated_on for x in got.stats]), labels,
        tenergy.EnergyParams(**p), precision)
    if closed:
        assert got.energy_total_j < duty_bill.energy_total_j
    else:
        assert got.energy_per_frame == tenergy.hypersense_measured(
            float(np.mean([x.gated_on for x in got.stats])),
            tenergy.EnergyParams(**p), precision)
