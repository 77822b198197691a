"""The paper's full loop on the PyTorch port: HDC gate -> HP capture ->
backbone detector. The twin of ``examples/gated_cascade.py``.

A closed-loop StreamRunner gates a sparse-event radar stream, its
high-precision burst drains feed a CascadeService backbone (the smoke
``hubert-xlarge`` detector, its step captured once in a CUDA graph on the
card), and the capture log bills the whole system against an always-on
detector. Runs on the card by default, on the CPU with ``--device cpu``.

The gate, the stream and the detector's weights are drawn from seeded
CPU generators and moved to the device, so a run prints the same
decisions on the card as on the CPU. The seeds are the reference's keys
plus 10: the untrained gate's closed loop must pass frames to the
detector, and at seeds 1-3 the port's draws leave it idle.

Run:  PYTHONPATH=src python examples/gated_cascade_torch.py
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import encoding, hypersense
from repro_torch.core.sensor_control import CaptureConfig, ControllerConfig
from repro_torch.launch import steps
from repro_torch.launch.cascade import CascadeService
from repro_torch.sensing import synthetic
from repro_torch.sensing.stream import StreamRunner

FRAME, CHUNK, BATCH = 32, 16, 8
#: added to the reference's PRNG keys (1, 2, 3, 7) to seed the generators
SEED = 10
#: the lines a run prints, in order, with their numbers named (read by
#: ``chip_smoke.py`` and ``tests/test_torch_examples.py``); the first, one
#: for each frame the detector scored, repeats
LINES = (r"frame +\d+  detector class [01]  logits \[.*\]",
         r"gate duty cycle +(?P<duty>\d\.\d{3})",
         r"backbone builds +(?P<builds>\d+) \(ragged drains, fixed shapes\)",
         r"cascade +J/frame +(?P<cascade_j_per_frame>\d+\.\d{4})",
         r"always-on J/frame +(?P<always_on_j_per_frame>\d+\.\d{4})  "
         r"\(saving (?P<saving_pct>-?\d+\.\d)%\)")


def open_loop_threshold(gate: hypersense.HyperSenseModel, stream
                        ) -> tuple[hypersense.HyperSenseModel, np.ndarray]:
    """The gate thresholded at the open-loop frame-score q75 (at
    ``t_detection`` 0), so only score peaks fire (closed-loop decimation
    skips idle frames, thinning high scores); and those scores."""
    scores = hypersense.frame_scores_batch(gate, stream, 0).cpu().numpy()
    return (dataclasses.replace(gate,
                                t_score=float(np.quantile(scores, 0.75))),
            scores)


def gated_cascade(gate: hypersense.HyperSenseModel, stream,
                  casc: CascadeService, *, chunk: int = CHUNK) -> dict:
    """Run the closed loop a chunk at a time, pumping each ragged HP drain
    into ``casc``, then flush it. Returns the runner, the collected
    batches, the gate's duty cycle, the backbone's builds and the system
    energy (``CascadeService.system_energy``)."""
    runner = StreamRunner(gate,
                          ControllerConfig(base_rate_hz=10.0,
                                           active_rate_hz=30.0,
                                           hold_frames=4),
                          chunk_size=chunk,
                          control=CaptureConfig(hp_bits=12),
                          device=casc.device)
    for t in range(0, len(stream), chunk):
        runner.process(stream[t:t + chunk])
        casc.pump(runner)                 # ragged drain -> fixed batches
    batches = casc.flush()
    log = runner.capture_log
    return {"runner": runner, "batches": batches,
            "duty": float(np.asarray(log.gated, bool).mean()),
            "builds": casc.rebuild_count(),
            "energy": casc.system_energy(log)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, failing without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)

    def gen(seed):
        return torch.Generator().manual_seed(SEED + seed)

    # a tiny gate (untrained weights are fine for the plumbing demo)
    B0, b = encoding.make_perm_base_rows(gen(1), 8, 256)
    gate = hypersense.HyperSenseModel(
        torch.randn((2, 256), generator=gen(2)), B0, b,
        h=8, w=8, stride=4, t_score=0.0, t_detection=1).to(dev)
    stream, _ = synthetic.make_drift_stream(
        gen(3), 8 * CHUNK, synthetic.RadarConfig(height=FRAME, width=FRAME),
        event_prob=0.03, event_len=10, device=dev)
    gate, _ = open_loop_threshold(gate, stream)

    # the downstream detector: smoke embeds-in backbone + patch embedder
    cfg = configs.get_smoke("hubert-xlarge")
    params = steps.init_detector_params(gen(7), cfg,
                                        frame_hw=(FRAME, FRAME), patch=8)
    casc = CascadeService(params, cfg, batch_size=BATCH,
                          frame_hw=(FRAME, FRAME), device=dev)

    out = gated_cascade(gate, stream, casc)
    if not out["batches"]:
        raise RuntimeError("the gate passed no frame to the detector: the "
                           "cascade never ran")
    for batch in out["batches"]:
        for i, logit in zip(batch.frame_idx, batch.logits):
            print(f"frame {int(i):4d}  detector class {int(np.argmax(logit))}"
                  f"  logits {np.round(logit, 3)}")

    e = out["energy"]
    print(f"\ngate duty cycle      {out['duty']:.3f}")
    print(f"backbone builds      {out['builds']} "
          f"(ragged drains, fixed shapes)")
    print(f"cascade   J/frame    {e['cascade'].total:.4f}")
    print(f"always-on J/frame    {e['always_on'].total:.4f}  "
          f"(saving {1 - e['cascade'].total / e['always_on'].total:.1%})")


if __name__ == "__main__":
    main()
