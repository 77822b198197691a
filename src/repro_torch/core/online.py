"""Online learning for the HDC classifier (paper §I, §III-A) on PyTorch.

Twin of ``repro.core.online``: the similarity-scaled perceptron rule as
pure functions over explicit ``class_hvs`` tensors, which the streaming
runner threads through its chunks.

* :func:`online_update` — one labeled sample, one update.
* :func:`chunk_update` — fold a chunk of (hv, label) samples sequentially
  (a Python loop in place of ``lax.scan``); each step scores against the
  running classifier, so chunk size is invisible to the trajectory.
* :func:`chunk_update_pseudo` — confidence-gated self-training.
* :class:`AdaptConfig` — the adaptation policy the runners carry.

Every step stays on the device: masks and decisions are tensors selected
with ``torch.where``, never read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import hdc


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Adaptation policy: ``mode`` ``"label"`` (per-frame labels fed to
    ``process``) or ``"pseudo"`` (confident self-training); ``lr`` scales
    the update; ``confidence`` is the minimum top-2 margin of a pseudo
    update; ``scope`` ``"shared"`` or (fleets) ``"per-stream"``."""
    mode: Literal["label", "pseudo"] = "label"
    lr: float = 0.5
    confidence: float = 0.25
    scope: Literal["shared", "per-stream"] = "shared"


def _row_update(class_hvs: torch.Tensor, row: torch.Tensor,
                vec: torch.Tensor) -> torch.Tensor:
    """``zeros_like(class_hvs).at[row].set(vec)`` with a tensor ``row``."""
    onehot = torch.arange(class_hvs.shape[0], device=class_hvs.device) == row
    return torch.where(onehot[:, None], vec[None, :], 0.0)


def online_update(class_hvs: torch.Tensor, hv: torch.Tensor,
                  y: torch.Tensor, lr: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One similarity-scaled perceptron update (paper step 4): if the sample
    is mispredicted, ``C_y += lr*(1-delta_y)*hv`` and ``C_pred -= ...``.
    Returns ``(new class_hvs, wrong)``."""
    scores = hdc.class_scores(hv[None, :], class_hvs)[0]            # (C,)
    pred = torch.argmax(scores)
    delta = scores[y]
    rate = lr * (1.0 - delta)
    wrong = pred != y
    upd = _row_update(class_hvs, y, rate * hv)
    upd = upd + _row_update(class_hvs, pred,
                            torch.where(wrong, -rate, 0.0) * hv)
    return class_hvs + torch.where(wrong, 1.0, 0.0) * upd, wrong


def pseudo_update(class_hvs: torch.Tensor, hv: torch.Tensor, *,
                  lr: float = 1.0, confidence: float = 0.25
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One confidence-gated self-training update: reinforce the predicted
    class when the top-2 score margin clears ``confidence``. Returns
    ``(new class_hvs, updated)``."""
    scores = hdc.class_scores(hv[None, :], class_hvs)[0]
    top2 = torch.topk(scores, 2).values
    pred = torch.argmax(scores)
    rate = lr * (1.0 - scores[pred])
    confident = (top2[0] - top2[1]) >= confidence
    upd = _row_update(class_hvs, pred, rate * hv)
    return class_hvs + torch.where(confident, 1.0, 0.0) * upd, confident


def chunk_update(class_hvs: torch.Tensor, hvs: torch.Tensor,
                 labels: torch.Tensor, *, lr: float = 1.0,
                 valid: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a chunk of labeled samples through :func:`online_update`;
    ``valid`` masks padded samples (they leave the state bitwise
    untouched). Returns ``(new class_hvs, wrong (N,) bool)``."""
    if valid is None:
        valid = torch.ones(hvs.shape[0], dtype=torch.bool, device=hvs.device)
    valid = valid.to(torch.bool)
    wrong = []
    for i in range(hvs.shape[0]):
        new, wr = online_update(class_hvs, hvs[i], labels[i], lr)
        class_hvs = torch.where(valid[i], new, class_hvs)
        wrong.append(wr & valid[i])
    return class_hvs, torch.stack(wrong)


def chunk_update_pseudo(class_hvs: torch.Tensor, hvs: torch.Tensor, *,
                        lr: float = 1.0, confidence: float = 0.25,
                        valid: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a chunk of unlabeled samples through :func:`pseudo_update`.
    Returns ``(new class_hvs, updated (N,) bool)``."""
    if valid is None:
        valid = torch.ones(hvs.shape[0], dtype=torch.bool, device=hvs.device)
    valid = valid.to(torch.bool)
    did = []
    for i in range(hvs.shape[0]):
        new, d = pseudo_update(class_hvs, hvs[i], lr=lr,
                               confidence=confidence)
        class_hvs = torch.where(valid[i], new, class_hvs)
        did.append(d & valid[i])
    return class_hvs, torch.stack(did)


def apply_chunk(config: AdaptConfig, class_hvs: torch.Tensor,
                hvs: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch one chunk through the configured update mode (``labels``
    is ignored in ``"pseudo"`` mode)."""
    if config.mode == "label":
        return chunk_update(class_hvs, hvs, labels, lr=config.lr,
                            valid=valid)
    if config.mode == "pseudo":
        return chunk_update_pseudo(class_hvs, hvs, lr=config.lr,
                                   confidence=config.confidence,
                                   valid=valid)
    raise ValueError(f"unknown adaptation mode {config.mode!r}")
