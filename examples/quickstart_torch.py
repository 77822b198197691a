"""Quickstart on the PyTorch port: train a HyperSense fragment model and
score a frame. The twin of ``examples/quickstart.py``.

Steps 1-5 of the reference at its sizes (80 frames of 64x64, a 4-bit ADC,
16x16 fragments, D=4096, 10 retraining epochs, stride 8): training
encodes through the ``hdc_encode_perm`` kernel and scores through the
``similarity`` kernel, the held-out fragments are scored through
``similarity`` again, and the frame decisions come from the float
sliding-window scorer. Runs on the card by default, on the CPU with
``--device cpu``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fragment_model as fm
from repro_torch.core import hypersense, metrics
from repro_torch.core.encoding import encode_fragments
from repro_torch.sensing import adc, fragments, synthetic

FRAME, FRAG, STRIDE, DIM, EPOCHS = 64, 16, 8, 4096, 10
#: the lines a run prints, in order, with their numbers named (read by
#: ``chip_smoke.py`` and ``tests/test_torch_examples.py``)
LINES = (r"retraining val accuracy: \[(?:\d\.\d+(?:, )?){%d}\]" % EPOCHS,
         r"fragment AUC: (?P<auc>\d\.\d{3})",
         r"frame decisions: \[[01 ]+\]",
         r"frame labels: +\[[01 ]+\]")


def fragment_auc(model: fm.FragmentModel, frags, labels
                 ) -> tuple[np.ndarray, float]:
    """Step 4: the held-out fragments' detection scores and their AUC."""
    hv = encode_fragments(torch.as_tensor(frags, device=model.B.device),
                          model.B, model.b)
    scores = fm.positive_score(model.class_hvs, hv).cpu().numpy()
    fpr, tpr, _ = metrics.roc_curve(scores, labels)
    return scores, metrics.auc(fpr, tpr)


def frame_decisions(model: fm.FragmentModel, frames, *, frag: int = FRAG,
                    stride: int = STRIDE) -> np.ndarray:
    """Step 5: frame-level detection through the sliding-window scorer,
    reusing the fragment model's encoder (its generator rows)."""
    B0 = model.B.reshape(frag, frag, -1)[:, 0, :]
    hs = hypersense.from_fragment_model(model, B0, h=frag, w=frag,
                                        stride=stride, t_score=0.0,
                                        t_detection=0)
    return hypersense.detect_batch(hs, frames).cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, failing without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)

    # 1. sense: synthetic radar frames through the low-precision ADC path
    cfg = synthetic.RadarConfig(height=FRAME, width=FRAME)
    frames, masks, labels = synthetic.make_dataset(
        torch.Generator(device=dev).manual_seed(0), 80, cfg, device=dev)
    frames_lp = adc.quantize(frames, bits=4)

    # 2. fragment dataset (balanced positives/negatives)
    frags, flabels = fragments.sample_fragments(
        frames_lp.cpu().numpy(), masks.cpu().numpy(), h=FRAG, w=FRAG,
        per_frame=2, seed=0)
    n = len(frags)
    tr, te = slice(0, int(n * 0.8)), slice(int(n * 0.8), n)

    # 3. train the HDC Fragment model (bundling + retraining)
    model, info = fm.train_fragment_model(
        torch.Generator(device=dev).manual_seed(1), frags[tr], flabels[tr],
        dim=DIM, epochs=EPOCHS, device=dev)
    print("retraining val accuracy:", [round(a, 3)
                                       for a in info["val_accuracy"]])

    # 4. fragment-level ROC
    _, auc = fragment_auc(model, frags[te], flabels[te])
    print(f"fragment AUC: {auc:.3f}")

    # 5. frame-level HyperSense detection (sliding window, reuse encoder)
    decisions = frame_decisions(model, frames_lp[:16])
    print("frame decisions:", decisions.astype(int))
    print("frame labels:   ", labels[:16].cpu().numpy())


if __name__ == "__main__":
    main()
