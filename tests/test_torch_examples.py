"""PyTorch port, the port-side examples: ``examples/*_torch.py``, each the
twin of the reference's example of the same name, run on the CPU with
small arguments in a subprocess (``--device cpu``):

* ``fault_tolerance_demo_torch.py``: its three phases, the relaunch
  resumed at step 6 and finished at 10, the elastic restore's blocks on
  a one-rank mesh the checkpoint's;
* ``train_backbone_torch.py`` on the smoke config: the run's last
  checkpoint at its last step, a relaunch resumed there;
* ``serve_backbone_torch.py``: its requests served, two runs equal;
* ``quickstart_torch.py``, ``gated_cascade_torch.py`` and
  ``intelligent_sensing_e2e_torch.py`` (its four modes, small
  ``--frames``): every line the reference prints, and one backbone build;
* without ``--device`` each refuses to run off the card, and none
  imports JAX or the reference.

Then the last three twins' stages in process, against the reference's
library calls (the ones its example makes, in its order) on the same
``np.random.default_rng`` gate arrays and frames (``_torch_parity``),
at 32x32 frames, 8x8 fragments, stride 4, D 256. Tolerances: fragment
and frame scores and ``T_score`` within ``SCORE_ATOL`` (the reference's
cross-platform score tolerance); decisions, duty cycles, missed and
false-active rates, the capture log, HP drains and each fleet sensor's
stats exactly, behind the precondition that every deciding score sits
``DECISION_MARGIN`` from ``t_score``; energy totals and savings, for
those equal stats, within ``ENERGY_RTOL`` relative; an AUC within the
share of its positive-negative pairs whose scores lie within
``2 * SCORE_ATOL`` of one another (where the two packages may order a
pair apart); the cascade's float32 smoke logits within ``F32_RTOL`` of
the largest |logit| (``test_torch_cascade.py``'s bound). Training from a
key is not compared (``test_torch_fragment_model.py`` holds it).
"""

import dataclasses
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (FRAG, SCORE_ATOL, STRIDE, assert_margin, frames,
                           model_arrays, models, pick_threshold, t)
from repro import configs as jconfigs
from repro.core import energy as jenergy
from repro.core import fragment_model as jfm
from repro.core import hypersense as jhs
from repro.core import metrics as jmetrics
from repro.core.encoding import encode_fragments as jencode_fragments
from repro.core.encoding import flat_perm_base as jflat_perm_base
from repro.core.online import AdaptConfig as JAdapt
from repro.core.sensor_control import CaptureConfig as JCapture
from repro.core.sensor_control import ControllerConfig as JController
from repro.core.sensor_control import decimation as jdecimation
from repro.core.sensor_control import stats_from as jstats_from
from repro.launch import cascade as jcascade
from repro.launch import steps as jsteps
from repro.sensing import adc as jadc
from repro.sensing.fleet import simulate_fleet as jsimulate_fleet
from repro.sensing.stream import StreamRunner as JStreamRunner
from repro.sensing.stream import \
    simulate_stream_batched as jsimulate_stream_batched
from repro_torch import configs
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.convert import (detector_params_from_arrays,
                                 fragment_model_from_arrays,
                                 model_from_arrays)
from repro_torch.core import hypersense as ths
from repro_torch.core.sensor_control import ControllerConfig
from repro_torch.launch.cascade import CascadeService
from repro_torch.sensing import adc as tadc
from test_torch_core import _imported_modules

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["fault_tolerance_demo_torch", "train_backbone_torch",
            "serve_backbone_torch", "quickstart_torch",
            "gated_cascade_torch", "intelligent_sensing_e2e_torch"]
D = 256
ENERGY_RTOL = 1e-6
F32_RTOL = 1e-5
ARCH = "hubert-xlarge"


def run_example(name, *args):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="2"))


def test_fault_tolerance_demo():
    out = run_example("fault_tolerance_demo_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert "[demo] latest checkpoint: step 6" in lines
    assert "[train] resumed from step 6" in lines
    assert "[demo] resumed and finished at step 10" in lines
    assert any(ln.startswith("[demo] elastic restore ok (step 10) onto a "
                             "(1, 1) mesh") for ln in lines), out.stdout


def test_train_backbone(tmp_path):
    args = ["--device", "cpu", "--smoke", "--steps", "12", "--batch", "2",
            "--seq", "16", "--ckpt-dir", os.fspath(tmp_path)]
    out = run_example("train_backbone_torch", *args)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("params: ")
    assert "loss: first " in out.stdout.splitlines()[-1]
    assert tckpt.latest_step(os.fspath(tmp_path)) == 12
    again = run_example("train_backbone_torch", *args[:4], "24",
                        *args[5:])
    assert again.returncode == 0, again.stdout + again.stderr
    assert "[train] resumed from step 12" in again.stdout
    assert tckpt.latest_step(os.fspath(tmp_path)) == 24


def test_serve_backbone():
    out = run_example("serve_backbone_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("served 4 requests, 24 new tokens each")
    assert lines[1].startswith("first request tokens: [")
    assert lines[-1] == "determinism check passed"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_card_by_default(name):
    """Without ``--device`` an example runs on CUDA and, with no card
    there, fails rather than falling back to the CPU; its imports are
    the port's."""
    for mod in _imported_modules(ROOT / "examples" / f"{name}.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    out = run_example(name)
    assert out.returncode != 0 and "CUDA" in out.stderr, out.stderr


# ---------------------------------------------------------------------------
# the paper's loop: the three newest twins in subprocesses
# ---------------------------------------------------------------------------

def test_quickstart():
    qs = example("quickstart_torch")
    out = run_example("quickstart_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(qs.LINES), out.stdout
    found = [re.fullmatch(p, ln) for ln, p in zip(lines, qs.LINES)]
    assert all(found), list(zip(lines, qs.LINES))
    assert float(found[1]["auc"]) > 0.6, lines[1]   # the model learned
    for line in lines[2:4]:
        assert len(line[line.index("[") + 1:-1].split()) == 16, line


def test_gated_cascade():
    gc = example("gated_cascade_torch")
    out = run_example("gated_cascade_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    frames_out = [ln for ln in lines if ln.startswith("frame ")]
    assert frames_out and all(re.fullmatch(gc.LINES[0], ln)
                              for ln in frames_out), out.stdout
    tail = [re.fullmatch(p, ln) for ln, p in zip(lines[-4:], gc.LINES[1:])]
    assert all(tail), lines[-4:]
    assert 0.0 < float(tail[0]["duty"]) < 1.0
    assert tail[1]["builds"] == "1"
    assert (float(tail[2]["cascade_j_per_frame"])
            < float(tail[3]["always_on_j_per_frame"]))


#: the e2e twin's modes at small ``--frames``: their arguments (the lines
#: each must print are the twin's ``LINES``)
E2E_MODES = {"stream": (),
             "fleet": ("--sensors", "2", "--frames", "64"),
             "drift": ("--drift", "--frames", "96"),
             "control": ("--control", "--frames", "96")}


@pytest.mark.parametrize("mode", list(E2E_MODES))
def test_intelligent_sensing_e2e(mode):
    patterns = list(example("intelligent_sensing_e2e_torch").LINES[mode])
    if mode == "fleet":                  # a sensor line for each sensor
        patterns[1:2] *= 2
    out = run_example("intelligent_sensing_e2e_torch", "--device", "cpu",
                      *E2E_MODES[mode])
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(patterns), out.stdout
    found = [re.fullmatch(p, ln) for ln, p in zip(lines, patterns)]
    assert all(found), list(zip(lines, patterns))
    if mode == "fleet":
        assert [m["sensor"] for m in found[1:3]] == ["0", "1"]
        assert (found[3]["sensors"], found[3]["frames"]) == ("2", "64")
    if mode == "control":
        assert (found[1]["decim"], found[1]["frames"]) == ("6", "96")


# ---------------------------------------------------------------------------
# the three twins' stages in process against the reference's library calls
# ---------------------------------------------------------------------------

def example(name):
    """An ``examples/*_torch.py`` module, loaded from its file."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def event_frames(seed: int, n: int, starts=(10, 52), length: int = 6,
                 h: int = 32, w: int = 32):
    """``(n, h, w)`` noise frames with a blob moving across the bursts of
    ``length`` frames at ``starts`` (long idle stretches between), and
    their labels."""
    rng = np.random.default_rng(seed)
    out = rng.uniform(0.0, 0.6, (n, h, w))
    labels = np.zeros(n, np.int32)
    yy, xx = np.mgrid[:h, :w]
    for start in starts:
        cy, cx = rng.uniform(8, h - 8), rng.uniform(8, w - 8)
        for i in range(start, min(start + length, n)):
            labels[i] = 1
            out[i] += 0.9 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
            cy, cx = cy + rng.uniform(-1, 1), cx + rng.uniform(-1, 1)
    return np.clip(out, 0.0, 1.5).astype(np.float32), labels


def bundled_models(seed: int):
    """A gate that tells blobs from noise, in both packages: the class
    hypervectors bundled (``bundle_init``) from the reference's encodings
    of fragments centred on a blob and of noise fragments, on
    ``model_arrays(seed, D)``'s base."""
    _, B0, b = model_arrays(seed, D)
    rng = np.random.default_rng(seed + 1)
    yy, xx = np.mgrid[:FRAG, :FRAG]
    crops = rng.uniform(0.0, 0.6, (64, FRAG, FRAG))
    labels = np.arange(64) % 2
    c = (FRAG - 1) / 2
    crops[1::2] += 0.9 * np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / 18.0)
    crops = np.clip(crops, 0.0, 1.5).astype(np.float32)
    B = jflat_perm_base(jnp.asarray(B0), FRAG)
    hv = jencode_fragments(jnp.asarray(crops), B, jnp.asarray(b))
    C = np.asarray(jfm.bundle_init(hv, jnp.asarray(labels)))
    jm = jhs.HyperSenseModel(jnp.asarray(C), jnp.asarray(B0), jnp.asarray(b),
                             FRAG, FRAG, STRIDE, t_score=0.0, t_detection=0)
    tm = model_from_arrays(C, B0, b, h=FRAG, w=FRAG, stride=STRIDE,
                           t_score=0.0, t_detection=0, device="cpu")
    return jm, tm


def with_threshold(jm, tm, t_score: float):
    return (jm._replace(t_score=t_score),
            dataclasses.replace(tm, t_score=t_score))


def lp_views(fr):
    """The 4-bit ADC view of ``fr`` in each package (bitwise equal)."""
    jlp = np.asarray(jadc.quantize(jnp.asarray(fr), 4))
    tlp = tadc.quantize(t(fr), 4)
    np.testing.assert_array_equal(tlp.numpy(), jlp)
    return jlp, tlp


def auc_slack(scores, labels) -> float:
    """Share of positive-negative pairs whose scores lie within
    ``2 * SCORE_ATOL``: the most two AUCs of scores within SCORE_ATOL of
    each other can differ by."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels).astype(bool)
    close = np.abs(s[y][:, None] - s[~y][None, :]) <= 2 * SCORE_ATOL
    return float(close.sum()) / max(close.size, 1)


def assert_scores(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= SCORE_ATOL


def assert_rel(got: float, want: float, rtol: float = ENERGY_RTOL):
    assert abs(got - want) <= rtol * abs(want), (got, want)


def assert_stats(got, want):
    np.testing.assert_array_equal(np.asarray(got.decisions),
                                  np.asarray(want.decisions))
    np.testing.assert_array_equal(np.asarray(got.gated_on),
                                  np.asarray(want.gated_on))
    for f in ("duty_cycle", "missed_positive", "false_active"):
        np.testing.assert_equal(getattr(got, f), getattr(want, f))


def test_quickstart_stages_match_the_reference():
    """Steps 4 and 5 of ``quickstart.py``: the held-out fragments'
    scores and AUC, and the frame decisions at ``t_score`` 0."""
    qs = example("quickstart_torch")
    C, B0, b = model_arrays(40, D)
    B = np.asarray(jflat_perm_base(jnp.asarray(B0), FRAG))
    jmodel = jfm.FragmentModel(jnp.asarray(C), jnp.asarray(B),
                               jnp.asarray(b))
    tmodel = fragment_model_from_arrays(C, B, b, device="cpu")
    fr, labels = frames(41, 16)
    jlp, tlp = lp_views(fr)
    rng = np.random.default_rng(42)
    ys = rng.integers(0, fr.shape[1] - FRAG + 1, 48)
    xs = rng.integers(0, fr.shape[2] - FRAG + 1, 48)
    src = rng.integers(0, len(fr), 48)
    frags = np.stack([jlp[i, y:y + FRAG, x:x + FRAG]
                      for i, y, x in zip(src, ys, xs)])
    flabels = labels[src]

    # 4. fragment-level ROC
    hv = jencode_fragments(jnp.asarray(frags), jmodel.B, jmodel.b)
    want = np.asarray(jfm.positive_score(jmodel.class_hvs, hv))
    fpr, tpr, _ = jmetrics.roc_curve(want, flabels)
    got, auc = qs.fragment_auc(tmodel, frags, flabels)
    assert_scores(got, want)
    assert abs(auc - jmetrics.auc(fpr, tpr)) <= auc_slack(want, flabels)

    # 5. frame decisions through the sliding-window scorer
    jB0 = jmodel.B.reshape(FRAG, FRAG, -1)[:, 0, :]
    hs = jhs.from_fragment_model(jmodel, jB0, h=FRAG, w=FRAG, stride=STRIDE,
                                 t_score=0.0, t_detection=0)
    assert_margin(np.asarray(jhs.frame_scores_batch(hs, jlp, 0)), 0.0)
    want = np.asarray(jhs.detect_batch(hs, jlp))
    got = qs.frame_decisions(tmodel, tlp, frag=FRAG, stride=STRIDE)
    np.testing.assert_array_equal(got, want)


def test_gated_cascade_matches_the_reference():
    """``gated_cascade.py``'s loop: the open-loop q75 threshold, the
    closed loop's capture log and HP drains, the backbone's batches and
    logits (the reference's detector weights carried across), one build,
    and the system energy billed on the port's measured backbone cost."""
    gc = example("gated_cascade_torch")
    hw = (gc.FRAME, gc.FRAME)
    jgate, tgate = models(50, D, t_detection=1)
    stream, _ = frames(51, 8 * gc.CHUNK, *hw)

    # the reference, in its example's order
    jscores = np.asarray(jhs.frame_scores_batch(jgate, stream, 0,
                                                sequential=True))
    jgate = jgate._replace(t_score=float(np.quantile(jscores, 0.75)))
    tgate, tscores = gc.open_loop_threshold(tgate, t(stream))
    assert_scores(tscores, jscores)
    assert abs(tgate.t_score - jgate.t_score) <= SCORE_ATOL
    assert_margin(ths.frame_scores_batch(tgate, t(stream)).numpy(),
                  tgate.t_score)
    jrunner = JStreamRunner(jgate, JController(base_rate_hz=10.0,
                                               active_rate_hz=30.0,
                                               hold_frames=4),
                            chunk_size=gc.CHUNK,
                            control=JCapture(hp_bits=12))
    ref_params = jsteps.init_detector_params(
        jax.random.PRNGKey(7), jconfigs.get_smoke(ARCH), frame_hw=hw,
        patch=8)
    jcasc = jcascade.CascadeService(ref_params, jconfigs.get_smoke(ARCH),
                                    batch_size=gc.BATCH, frame_hw=hw)
    for lo in range(0, len(stream), gc.CHUNK):
        jrunner.process(stream[lo:lo + gc.CHUNK])
        jcasc.pump(jrunner)
    jbatches = jcasc.flush()
    jlog = jrunner.capture_log

    casc = CascadeService(
        detector_params_from_arrays(jax.tree.map(np.asarray, ref_params),
                                    device="cpu"),
        configs.get_smoke(ARCH), batch_size=gc.BATCH, frame_hw=hw,
        device="cpu")
    out = gc.gated_cascade(tgate, t(stream), casc)
    log = out["runner"].capture_log
    np.testing.assert_array_equal(log.sampled, jlog.sampled)
    np.testing.assert_array_equal(log.gated, jlog.gated)
    assert out["duty"] == float(np.asarray(jlog.gated, bool).mean()) > 0
    idx = np.concatenate([b_.frame_idx for b_ in out["batches"]])
    np.testing.assert_array_equal(
        idx, np.concatenate([b_.frame_idx for b_ in jbatches]))
    got = np.concatenate([b_.logits for b_ in out["batches"]])
    want = np.concatenate([np.asarray(b_.logits) for b_ in jbatches])
    assert np.abs(got - want).max() <= F32_RTOL * np.abs(want).max()
    assert out["builds"] == jcasc.compile_count() == 1

    cost = casc.backbone_cost()
    jcost = jenergy.BackboneCost(flops=cost.flops, bytes=cost.bytes,
                                 joules=cost.joules)
    e = out["energy"]
    assert_rel(e["cascade"].total, jenergy.cascade_system(jlog, jcost).total)
    assert_rel(e["always_on"].total, jenergy.always_on_backbone(jcost).total)


def test_e2e_operating_point_matches_the_reference():
    """``train_gate``'s second half: held-out frame scores at
    ``t_detection`` 0, and ``T_score`` and the TPR at FPR <= 0.1."""
    e2e = example("intelligent_sensing_e2e_torch")
    jm, tm = bundled_models(60)
    fr, labels = frames(61, 24)
    jlp, tlp = lp_views(fr)
    want = np.asarray(jhs.frame_scores_batch(jm, jlp, 0, sequential=True))
    fpr, tpr, thr = jmetrics.roc_curve(want, labels)
    t_score = jmetrics.threshold_at_fpr(fpr, tpr, thr, 0.1)
    op = e2e.operating_point(tm, tlp, labels)
    assert_scores(op["scores"], want)
    # no positive-negative pair within 2 * SCORE_ATOL: both packages
    # sweep the same ROC points
    assert auc_slack(want, labels) == 0
    assert abs(op["t_score"] - t_score) <= SCORE_ATOL
    assert op["gate"].t_score == op["t_score"]
    assert op["tpr"] == jmetrics.tpr_at_fpr(fpr, tpr, 0.1) > 0


def test_e2e_single_stream_matches_the_reference():
    """The default mode: the stream's stats at a 4-bit ADC, and the
    energy account (``calibrate``, ``hypersense``, ``savings``)."""
    e2e = example("intelligent_sensing_e2e_torch")
    jm, tm = models(62, D)
    fr, labels = frames(63, 96)
    _, tlp = lp_views(fr)
    scores = ths.frame_scores_batch(tm, tlp).numpy()
    jm, tm = with_threshold(jm, tm, pick_threshold(scores))
    assert_margin(scores, tm.t_score)

    stats = jsimulate_stream_batched(jm, fr, labels,
                                     JController(hold_frames=3),
                                     chunk_size=32, backend="jnp",
                                     adc_bits=4)
    params = jenergy.calibrate()
    conv = jenergy.conventional(params)
    p_obj = float(np.mean(labels))
    ours = jenergy.hypersense(stats.false_active,
                              1.0 - stats.missed_positive, p_obj, params)
    s = jenergy.savings(ours, conv)

    r = e2e.single_stream(tm, t(fr), labels, ControllerConfig(hold_frames=3))
    assert_stats(r["stats"], stats)
    assert r["p_object"] == p_obj
    assert_rel(r["energy"].total, ours.total)
    assert_rel(r["total_saving"], s["total_saving"])
    assert_rel(r["edge_saving"], s["edge_saving"])


def test_e2e_fleet_matches_the_reference():
    """``--sensors``: each sensor's stats, the fleet's duty and its
    energy report (``simulate_fleet`` with ``calibrate``'s constants)."""
    e2e = example("intelligent_sensing_e2e_torch")
    jm, tm = models(64, D)
    data = [frames(65 + s, 64) for s in range(3)]
    fleet_frames = np.stack([f for f, _ in data])
    fleet_labels = np.stack([lb for _, lb in data])
    scores = ths.frame_scores_batch(
        tm, tadc.quantize(t(fleet_frames.reshape(-1, 32, 32)), 4)).numpy()
    jm, tm = with_threshold(jm, tm, pick_threshold(scores))
    assert_margin(scores, tm.t_score)

    want = jsimulate_fleet(jm, jnp.asarray(fleet_frames), fleet_labels,
                           JController(hold_frames=3), chunk_size=32,
                           backend="jnp", adc_bits=4,
                           energy_params=jenergy.calibrate())
    got = e2e.sensor_fleet(tm, t(fleet_frames), fleet_labels,
                           ControllerConfig(hold_frames=3))
    assert got.n_sensors == want.n_sensors == 3
    assert got.n_frames == want.n_frames == 64
    for g, w in zip(got.stats, want.stats):
        assert_stats(g, w)
    assert got.duty_cycle == want.duty_cycle
    assert_rel(got.energy_total_j, want.energy_total_j)
    assert_rel(got.baseline_total_j, want.baseline_total_j)
    assert_rel(got.total_saving, want.total_saving)


def test_e2e_drift_matches_the_reference():
    """``--drift``: the frozen, label-feedback and pseudo-label runs'
    scores and their AUCs over the second half."""
    e2e = example("intelligent_sensing_e2e_torch")
    jm, tm = models(66, D)
    fr, labels = frames(67, 96)
    scores = ths.frame_scores_batch(tm, t(fr)).numpy()
    jm, tm = with_threshold(jm, tm, pick_threshold(scores))
    assert_margin(scores, tm.t_score)

    control = JController(hold_frames=3)
    runs = {"frozen": (None, None),
            "label": (JAdapt(mode="label", lr=2.0), labels),
            "pseudo": (JAdapt(mode="pseudo", lr=0.5, confidence=0.02),
                       None)}
    got = e2e.drift(tm, t(fr), labels, ControllerConfig(hold_frames=3))
    half = len(labels) // 2
    for name, (adapt, feed) in runs.items():
        runner = JStreamRunner(jm, control, chunk_size=32, backend="jnp",
                               adapt=adapt)
        want, _, _ = runner.process(fr, labels=feed)
        fpr, tpr, _ = jmetrics.roc_curve(want[half:], labels[half:])
        assert_scores(got[name]["scores"], want)
        assert abs(got[name]["auc"] - jmetrics.auc(fpr, tpr)) <= auc_slack(
            want[half:], labels[half:]), name


def test_e2e_closed_loop_matches_the_reference():
    """``--control``: the closed loop's decisions, capture log, HP
    drain, stats and the capture-log energy bill."""
    e2e = example("intelligent_sensing_e2e_torch")
    jm, tm = bundled_models(68)
    fr, labels = event_frames(69, 96)
    _, tlp = lp_views(fr)
    scores = ths.frame_scores_batch(tm, tlp).numpy()
    jm, tm = with_threshold(jm, tm, pick_threshold(scores, 0.6, 0.95))
    assert_margin(scores, tm.t_score)

    rates = dict(base_rate_hz=10, active_rate_hz=60, hold_frames=6)
    runner = JStreamRunner(jm, JController(**rates), chunk_size=32,
                           backend="jnp", adc_bits=4,
                           control=JCapture(hp_bits=12))
    want, fired, gated = runner.process(fr)
    stats = jstats_from(fired, gated, labels)
    log = runner.capture_log
    hp_idx, hp_frames = runner.drain_hp()
    ours = jenergy.from_capture_log(log)
    always = jenergy.hypersense_measured(stats.duty_cycle)
    conv = jenergy.conventional()

    r = e2e.closed_loop(tm, t(fr), labels, ControllerConfig(**rates))
    assert r["decimation"] == jdecimation(JController(**rates)) == 6
    assert_scores(r["scores"], want)
    assert_stats(r["stats"], stats)
    np.testing.assert_array_equal(r["log"].sampled, log.sampled)
    np.testing.assert_array_equal(r["log"].gated, log.gated)
    assert r["lp_converted"] == int(log.sampled.sum()) < len(fr)
    np.testing.assert_array_equal(r["hp_idx"], hp_idx)
    np.testing.assert_array_equal(r["hp_frames"], np.asarray(hp_frames))
    assert (r["hp_bits"], r["hp_dropped"]) == (log.hp_bits,
                                               runner.hp_dropped)
    for key, want_e in (("ours", ours), ("always", always), ("conv", conv)):
        assert_rel(r[key].total, want_e.total)
    assert_rel(r["saving"], 1 - ours.total / conv.total)
