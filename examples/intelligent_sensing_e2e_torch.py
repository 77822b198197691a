"""End-to-end Intelligent Sensor Control on the PyTorch port (the paper's
full pipeline). The twin of ``examples/intelligent_sensing_e2e.py``.

sensor stream -> low-precision ADC -> HDC HyperSense gate -> high-precision
path + "cloud model" only when gated on -> energy accounting (Fig. 17).

Single-sensor by default; ``--sensors S`` runs the same trained gate over
S concurrent streams through the fleet runtime
(:mod:`repro_torch.sensing.fleet`): every super-chunk is scored in one
batched scorer call, each stream keeps its own controller hysteresis, and
the energy account aggregates the fleet. The ADC sits *inside* the
runtime (``adc_bits=4``) — the gate scores the cheap 4-bit capture while
the raw high-precision frames stand in for what the gated-on path would
deliver. ``--drift`` runs a drifting stream through a frozen gate and
through label-feedback and pseudo-label adaptation; ``--control`` closes
the capture loop and bills energy from the capture log.

The reference's ``--backend`` flag has no twin: the port has one
implementation per device, its hand-written kernels on the card (the
default) and their plain PyTorch versions under ``--device cpu``.

Each mode's work is a function of the gate model, the frames and the
labels that returns the numbers it prints; :func:`main` only draws the
data (from seeded ``torch.Generator``s) and prints.

Run:  PYTHONPATH=src python examples/intelligent_sensing_e2e_torch.py
      [--sensors 4 | --drift | --control] [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import energy, fragment_model as fm, hypersense, metrics
from repro_torch.core.online import AdaptConfig
from repro_torch.core.sensor_control import (CaptureConfig, ControllerConfig,
                                             decimation, stats_from)
from repro_torch.sensing import adc, fragments, synthetic
from repro_torch.sensing.fleet import simulate_fleet
from repro_torch.sensing.stream import StreamRunner, simulate_stream_batched

TARGET_FPR = 0.1
#: the paper's Table III point at FPR 0.1
PAPER = "(paper @FPR0.1: total 89.8%, edge 60.6%, QL 4.93%)"
_NUM = r"\d\.\d{3}"
_MISSED = rf"(?:{_NUM}|nan)"
_OPERATING = (r"operating point: FPR<=0\.1 -> "
              r"T_score=(?P<t_score>-?\d+\.\d{4}) TPR=(?P<tpr>\d\.\d{3})")
#: the lines each mode prints, in order, with their numbers named (read by
#: ``chip_smoke.py`` and ``tests/test_torch_examples.py``); a fleet's first
#: line after the operating point repeats, once for each sensor
LINES = {
    "stream": (
        _OPERATING,
        rf"stream: duty cycle (?P<duty>{_NUM}), missed positives "
        rf"(?P<missed>{_NUM}), false active (?P<false_active>{_NUM})",
        rf"p\(object\)=(?P<p_object>{_NUM}): total energy saving "
        r"(?P<total_saving_pct>-?\d+\.\d)%, edge saving "
        r"(?P<edge_saving_pct>-?\d+\.\d)%, quality loss "
        r"(?P<quality_loss_pct>\d+\.\d\d)%",
        r"\(paper @FPR0\.1: total (?P<paper_total_saving_pct>89\.8)%, edge "
        r"(?P<paper_edge_saving_pct>60\.6)%, QL (?P<paper_ql_pct>4\.93)%\)"),
    "fleet": (
        _OPERATING,
        rf"sensor (?P<sensor>\d+): duty (?P<sensor_duty>{_NUM}), missed "
        rf"(?P<sensor_missed>{_MISSED}), false-active "
        rf"(?P<sensor_false_active>{_NUM})",
        rf"fleet of (?P<sensors>\d+) x (?P<frames>\d+) frames: mean duty "
        rf"cycle (?P<duty>{_NUM})",
        r"fleet energy: (?P<energy_j>\d+\.\d) J vs always-on "
        r"(?P<always_on_j>\d+\.\d) J -> total saving "
        r"(?P<total_saving_pct>-?\d+\.\d)%"),
    "drift": (
        _OPERATING,
        rf"drifted-half frame-score AUC: frozen (?P<auc_frozen>{_NUM}), "
        rf"label-feedback (?P<auc_label>{_NUM}), pseudo-label "
        rf"(?P<auc_pseudo>{_NUM})"),
    "control": (
        _OPERATING,
        r"closed loop \(decim (?P<decim>\d+)\): LP-converted "
        r"(?P<lp_converted>\d+)/(?P<frames>\d+) frames, duty "
        rf"(?P<duty>{_NUM}), missed (?P<missed>{_MISSED})",
        r"HP deliverable: (?P<hp_frames>\d+) burst frames at "
        r"(?P<hp_bits>\d+) bits \(dropped (?P<hp_dropped>\d+)\)",
        r"energy/frame from capture log: (?P<capture_log_j>\d+\.\d{3}) J "
        r"\(always-on LP estimate (?P<always_on_lp_j>\d+\.\d{3}) J, "
        r"conventional (?P<conventional_j>\d+\.\d{3}) J\) -> saving "
        r"(?P<saving_pct>-?\d+\.\d)%"),
}


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def operating_point(hs: hypersense.HyperSenseModel, frames, labels,
                    target_fpr: float = TARGET_FPR) -> dict:
    """Pick ``T_score`` for a target FPR on held-out frames (paper
    §III-C): the gate with it, the threshold, the TPR there, and the
    frame scores (``t_detection`` 0) the ROC swept."""
    scores = hypersense.frame_scores_batch(hs, frames, 0).cpu().numpy()
    fpr, tpr, thr = metrics.roc_curve(scores, np.asarray(labels))
    t_score = metrics.threshold_at_fpr(fpr, tpr, thr, target_fpr)
    return {"gate": dataclasses.replace(hs, t_score=float(t_score)),
            "t_score": float(t_score),
            "tpr": metrics.tpr_at_fpr(fpr, tpr, target_fpr),
            "scores": scores}


def train_gate(device, cfg, frag: int, dim: int, stride: int) -> dict:
    """Train the Fragment model on low-precision captures and pick the
    operating T_score for a target FPR (paper §III-C);
    :func:`operating_point`'s record."""
    frames, masks, _ = synthetic.make_dataset(_gen(device, 0), 60, cfg,
                                              device=device)
    frames_lp = adc.quantize(frames, 4)
    frs, labs = fragments.sample_fragments(
        frames_lp.cpu().numpy(), masks.cpu().numpy(), h=frag, w=frag,
        per_frame=2, seed=0)
    model, _ = fm.train_fragment_model(_gen(device, 1), frs, labs, dim=dim,
                                       epochs=10, device=device)
    B0 = model.B.reshape(frag, frag, -1)[:, 0, :]

    te_frames, _, te_labels = synthetic.make_dataset(_gen(device, 2), 24,
                                                     cfg, device=device)
    te_lp = adc.quantize(te_frames, 4)
    hs = hypersense.from_fragment_model(model, B0, h=frag, w=frag,
                                        stride=stride)
    op = operating_point(hs, te_lp, te_labels.cpu().numpy())
    print(f"operating point: FPR<={TARGET_FPR} -> T_score="
          f"{op['t_score']:.4f} TPR={op['tpr']:.3f}")
    return op


def single_stream(hs, stream, labels, control: ControllerConfig) -> dict:
    """The default mode: one stream through the chunked runtime at a 4-bit
    ADC, and, where the stream drew an object event, the energy account
    (``energy.calibrate``'s fit of Table III) at the measured rates."""
    labels = np.asarray(labels)
    stats = simulate_stream_batched(hs, stream, labels, control,
                                    chunk_size=32, adc_bits=4,
                                    device=hs.device)
    out = {"stats": stats, "duty": stats.duty_cycle,
           "missed": stats.missed_positive,
           "false_active": stats.false_active,
           "p_object": float(np.mean(labels))}
    if not np.isfinite(stats.missed_positive):
        return out
    params = energy.calibrate()
    conv = energy.conventional(params)
    ours = energy.hypersense(stats.false_active, 1.0 - stats.missed_positive,
                             out["p_object"], params)
    out["energy"] = ours
    out.update(energy.savings(ours, conv))
    return out


def sensor_fleet(hs, frames, labels, control: ControllerConfig):
    """``--sensors S``: the ``(S, N, H, W)`` streams through one batched
    fleet runtime at a 4-bit ADC; the fleet's report."""
    return simulate_fleet(hs, frames, np.asarray(labels), control,
                          chunk_size=32, adc_bits=4,
                          energy_params=energy.calibrate(),
                          device=hs.device)


def late_auc(scores, labels) -> float:
    """Frame-score AUC over the drifted second half of the stream."""
    half = len(labels) // 2
    fpr, tpr, _ = metrics.roc_curve(scores[half:], labels[half:])
    return metrics.auc(fpr, tpr)


def drift(hs, stream, labels, control: ControllerConfig) -> dict:
    """``--drift``: the drifting stream through a frozen gate, label
    feedback and pseudo-label adaptation; each run's scores and its AUC
    over the drifted half."""
    labels = np.asarray(labels)
    runs = {"frozen": (None, None),
            "label": (AdaptConfig(mode="label", lr=2.0), labels),
            "pseudo": (AdaptConfig(mode="pseudo", lr=0.5, confidence=0.02),
                       None)}
    out = {}
    for name, (adapt, feed) in runs.items():
        runner = StreamRunner(hs, control, chunk_size=32, adapt=adapt,
                              device=hs.device)
        scores, _, _ = runner.process(stream, labels=feed)
        out[name] = {"scores": scores, "auc": late_auc(scores, labels)}
    return out


def closed_loop(hs, stream, labels, rates: ControllerConfig) -> dict:
    """``--control``: gate-driven variable-rate/-precision capture; energy
    billed from the capture log against the always-on LP estimate and the
    conventional pipeline."""
    runner = StreamRunner(hs, rates, chunk_size=32, adc_bits=4,
                          control=CaptureConfig(hp_bits=12),
                          device=hs.device)
    scores, fired, gated = runner.process(stream)
    stats = stats_from(fired, gated, np.asarray(labels))
    log = runner.capture_log
    hp_idx, hp_frames = runner.drain_hp()
    ours = energy.from_capture_log(log)
    always = energy.hypersense_measured(stats.duty_cycle)
    conv = energy.conventional()
    return {"scores": scores, "stats": stats, "log": log,
            "decimation": decimation(rates),
            "lp_converted": int(log.sampled.sum()), "hp_idx": hp_idx,
            "hp_frames": hp_frames,
            "hp_bits": log.hp_bits, "hp_dropped": runner.hp_dropped,
            "ours": ours, "always": always, "conv": conv,
            "saving": 1 - ours.total / conv.total}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sensors", type=int, default=1,
                    help="number of concurrent sensor streams (>1 uses "
                         "the fleet runtime)")
    ap.add_argument("--frames", type=int, default=150,
                    help="stream length per sensor")
    ap.add_argument("--drift", action="store_true",
                    help="drifting single-sensor stream: frozen gate vs "
                         "online adaptation (label feedback + pseudo)")
    ap.add_argument("--control", action="store_true",
                    help="close the capture loop: idle frames trickle at "
                         "base_rate_hz, gate bursts capture at "
                         "active_rate_hz + high precision; energy billed "
                         "from the capture log")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, failing without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)

    if args.control:
        # --- gate-driven variable-rate/-precision capture ----------------
        cfg = synthetic.RadarConfig(height=32, width=32)
        hs = train_gate(dev, cfg, 8, 1024, 4)["gate"]
        rates = ControllerConfig(base_rate_hz=10, active_rate_hz=60,
                                 hold_frames=6)
        stream, labels = synthetic.make_stream(
            _gen(dev, 3), args.frames, cfg, event_prob=0.01, event_len=12,
            device=dev)
        r = closed_loop(hs, stream, labels.cpu().numpy(), rates)
        print(f"closed loop (decim {r['decimation']}): "
              f"LP-converted {r['lp_converted']}/{len(stream)} "
              f"frames, duty {r['stats'].duty_cycle:.3f}, "
              f"missed {r['stats'].missed_positive:.3f}")
        print(f"HP deliverable: {len(r['hp_idx'])} burst frames at "
              f"{r['hp_bits']} bits (dropped {r['hp_dropped']})")
        print(f"energy/frame from capture log: {r['ours'].total:.3f} J "
              f"(always-on LP estimate {r['always'].total:.3f} J, "
              f"conventional {r['conv'].total:.3f} J) -> "
              f"saving {r['saving']:.1%}")
        return

    if args.drift:
        # --- online learning under distribution drift -------------------
        cfg = synthetic.RadarConfig(height=32, width=32)
        hs = train_gate(dev, cfg, 8, 1024, 4)["gate"]
        control = ControllerConfig(hold_frames=3)
        shift = synthetic.DriftConfig(background_gain=(0.0, 0.6),
                                      noise_sigma=(0.12, 0.28),
                                      object_intensity=(0.8, 0.35))
        stream, labels = synthetic.make_drift_stream(
            _gen(dev, 3), args.frames, cfg, shift, event_prob=0.05,
            event_len=10, device=dev)
        r = drift(hs, stream, labels.cpu().numpy(), control)
        print(f"drifted-half frame-score AUC: frozen {r['frozen']['auc']:.3f}"
              f", label-feedback {r['label']['auc']:.3f}, "
              f"pseudo-label {r['pseudo']['auc']:.3f}")
        return

    cfg = synthetic.RadarConfig(height=64, width=64)
    frag, dim, stride = 16, 2048, 8
    hs = train_gate(dev, cfg, frag, dim, stride)["gate"]
    control = ControllerConfig(hold_frames=3)

    if args.sensors <= 1:
        # --- single stream through the chunked runtime ------------------
        stream, stream_labels = synthetic.make_stream(
            _gen(dev, 3), args.frames, cfg, event_prob=0.03, event_len=10,
            device=dev)
        r = single_stream(hs, stream, stream_labels.cpu().numpy(), control)
        print(f"stream: duty cycle {r['duty']:.3f}, "
              f"missed positives {r['missed']:.3f}, "
              f"false active {r['false_active']:.3f}")
        if "energy" not in r:
            print("stream drew no object events (missed_positive is "
                  "undefined) — rerun with more --frames for the energy "
                  "account")
            return
        print(f"p(object)={r['p_object']:.3f}: total energy saving "
              f"{r['total_saving']:.1%}, edge saving "
              f"{r['edge_saving']:.1%}, quality loss {r['missed']:.2%}")
        print(PAPER)
        return

    # --- sensor fleet: S streams, one batched runtime -------------------
    streams, labels = [], []
    for s in range(args.sensors):
        fr, lb = synthetic.make_stream(
            _gen(dev, 3 + 1000 * s), args.frames, cfg, event_prob=0.03,
            event_len=10, device=dev)
        streams.append(fr)
        labels.append(lb.cpu().numpy())
    report = sensor_fleet(hs, torch.stack(streams), np.stack(labels),
                          control)
    for s, st in enumerate(report.stats):
        print(f"sensor {s}: duty {st.duty_cycle:.3f}, "
              f"missed {st.missed_positive:.3f}, "
              f"false-active {st.false_active:.3f}")
    print(f"fleet of {report.n_sensors} x {report.n_frames} frames: "
          f"mean duty cycle {report.duty_cycle:.3f}")
    print(f"fleet energy: {report.energy_total_j:.1f} J vs always-on "
          f"{report.baseline_total_j:.1f} J "
          f"-> total saving {report.total_saving:.1%}")


if __name__ == "__main__":
    main()
