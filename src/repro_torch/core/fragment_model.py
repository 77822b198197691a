"""The *Fragment model* — HDC classification over fragments (paper §III-C a)
on PyTorch.

Twin of ``repro.core.fragment_model``. Pipeline (paper Fig. 5a):

  (1) sample balanced positive/negative fragments  -> ``sensing.fragments``
  (2) normalize + HDC-encode: the permutation base through the
      ``hdc_encode_perm`` kernel, the i.i.d. base through ``ops.hdc_encode``
  (3) initial training: class hypervectors by bundling
  (4) iterative retraining: similarity-scaled perceptron updates
      (:func:`repro_torch.core.online.online_update`, one sample at a time)
  (5) model selection on validation accuracy

Scores, predictions and accuracy go through ``ops.similarity`` (the
similarity kernel on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import pin_fp32_matmul, resolve_device
from repro_torch.core import encoding, online
from repro_torch.core.encoding import NonLin
from repro_torch.kernels import ops
from repro_torch.kernels.hdc_encode_perm import hdc_encode_perm


@dataclasses.dataclass(frozen=True)
class FragmentModel:
    """HDC classifier state: ``class_hvs (C, D)`` class hypervectors (C=2
    for HyperSense: 0 = negative / no object, 1 = positive / object), the
    base projection ``B (n, D)`` and the RFF phase ``b (D,)``."""
    class_hvs: torch.Tensor
    B: torch.Tensor
    b: torch.Tensor


def encode(model: FragmentModel, frags: torch.Tensor,
           nonlinearity: NonLin = "rff") -> torch.Tensor:
    """``(N, h, w)`` fragments -> ``(N, D)`` hypervectors against the
    model's base, through ``ops.hdc_encode`` (normalized first)."""
    return ops.hdc_encode(frags, model.B, model.b, nonlinearity=nonlinearity)


def bundle_init(hvs: torch.Tensor, labels: torch.Tensor,
                num_classes: int = 2) -> torch.Tensor:
    """Initial training (paper step 3): ``C_i = sum_{y_j = i} phi(x_j)``."""
    one_hot = torch.nn.functional.one_hot(labels.to(torch.int64),
                                          num_classes).to(hvs.dtype)
    with pin_fp32_matmul():
        return one_hot.T @ hvs                                   # (C, D)


def init_fragment_model(generator: torch.Generator | None,
                        hvs: torch.Tensor, labels: torch.Tensor,
                        B: torch.Tensor, b: torch.Tensor,
                        num_classes: int = 2) -> FragmentModel:
    """Bundled model; ``generator`` is unused (bundling is deterministic)
    and kept for symmetry with the reference's key argument."""
    del generator
    return FragmentModel(bundle_init(hvs, labels, num_classes), B, b)


def retrain_epoch(class_hvs: torch.Tensor, hvs: torch.Tensor,
                  labels: torch.Tensor, lr: float = 1.0) -> torch.Tensor:
    """One retraining epoch (paper step 4): every sample in order through
    :func:`~repro_torch.core.online.online_update`; a mispredicted one moves
    its true class toward it and the predicted class away, scaled by
    ``lr * (1 - delta)``."""
    for i in range(hvs.shape[0]):
        class_hvs, _ = online.online_update(class_hvs, hvs[i], labels[i], lr)
    return class_hvs


def scores(class_hvs: torch.Tensor, hvs: torch.Tensor) -> torch.Tensor:
    """(N, C) cosine-similarity scores (paper inference, §III-A step 3)."""
    return ops.similarity(hvs, class_hvs)


def positive_score(class_hvs: torch.Tensor, hvs: torch.Tensor
                   ) -> torch.Tensor:
    """Detection score in [-1, 1] per fragment: sim(pos) - sim(neg), the
    ``s_i`` that ``t_score`` thresholds."""
    s = scores(class_hvs, hvs)
    return s[:, 1] - s[:, 0]


def predict(class_hvs: torch.Tensor, hvs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(scores(class_hvs, hvs), dim=-1)


def accuracy(class_hvs: torch.Tensor, hvs: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Share of correct predictions, in float32 as ``hits * (1/N)``: the
    reference's compiled mean multiplies by the reciprocal, so the two
    packages report the same accuracy to the last bit."""
    hits = torch.sum(predict(class_hvs, hvs) == labels).to(torch.float32)
    return hits * torch.tensor(1.0 / labels.shape[0], dtype=torch.float32)


def retrain(model: FragmentModel, hvs: torch.Tensor, labels: torch.Tensor, *,
            epochs: int = 20, lr: float = 1.0,
            val_hvs: torch.Tensor | None = None,
            val_labels: torch.Tensor | None = None
            ) -> tuple[FragmentModel, dict]:
    """Iterative retraining with best-epoch selection (paper steps 4-5):
    the epoch of highest validation accuracy wins, the first of equals."""
    best, best_metric = model.class_hvs, float("-inf")
    history = []
    chvs = model.class_hvs
    vh = hvs if val_hvs is None else val_hvs
    vl = labels if val_labels is None else val_labels
    for _ in range(epochs):
        chvs = retrain_epoch(chvs, hvs, labels, lr)
        acc = float(accuracy(chvs, vh, vl))
        history.append(acc)
        if acc > best_metric:
            best_metric, best = acc, chvs
    return dataclasses.replace(model, class_hvs=best), {
        "val_accuracy": history, "best": best_metric}


def train_fragment_model(generator: torch.Generator, frags, labels, *,
                         dim: int, epochs: int = 20, lr: float = 1.0,
                         base_kind: str = "perm",
                         nonlinearity: NonLin = "rff", val_frags=None,
                         val_labels=None,
                         device: str | torch.device | None = None
                         ) -> tuple[FragmentModel, dict]:
    """Train on raw fragments ``(N, h, w)`` (numpy or tensors) on ``device``
    (``None`` -> CUDA, raising without it).

    ``base_kind='perm'`` draws the ``h`` generator rows and encodes through
    the ``hdc_encode_perm`` kernel, never forming the expanded base for
    the encode; the model still carries ``B = flat_perm_base(B0, w)``, as
    the reference's does. ``'iid'`` draws a dense ``(h*w, D)`` base and
    encodes through ``ops.hdc_encode``. The base comes from ``generator``
    and is moved to ``device``.
    """
    dev = resolve_device(device)
    frags = torch.as_tensor(frags, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev).to(torch.int64)
    n, h, w = frags.shape
    if base_kind == "perm":
        B0, b = (a.to(dev) for a in
                 encoding.make_perm_base_rows(generator, h, dim))
        B = encoding.flat_perm_base(B0, w)

        def enc(f):
            x = encoding.normalize_flat(f.reshape(f.shape[0], h * w))
            return hdc_encode_perm(x, B0, b, h=h, w=w,
                                   nonlinearity=nonlinearity)
    elif base_kind == "iid":
        B, b = (a.to(dev) for a in
                encoding.make_iid_base(generator, h * w, dim))

        def enc(f):
            return ops.hdc_encode(f, B, b, nonlinearity=nonlinearity)
    else:
        raise ValueError(f"unknown base_kind {base_kind!r}")

    hvs = enc(frags)
    model = FragmentModel(bundle_init(hvs, labels), B, b)
    v_hvs = v_lab = None
    if val_frags is not None:
        v_hvs = enc(torch.as_tensor(val_frags, dtype=torch.float32,
                                    device=dev))
        v_lab = torch.as_tensor(val_labels, device=dev).to(torch.int64)
    return retrain(model, hvs, labels, epochs=epochs, lr=lr, val_hvs=v_hvs,
                   val_labels=v_lab)
