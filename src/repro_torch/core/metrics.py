"""Binary-detection metrics: ROC, AUC, partial AUC, F1 (paper §V-B).

The port's own copy of ``repro.core.metrics`` (the port imports nothing of
``repro``): pure numpy, no sklearn. Scores come in as numpy arrays (or
anything ``np.asarray`` takes, such as a CPU tensor). Matches the paper's
evaluation protocol:

* ROC curves sweep the decision threshold over every observed score.
* Table I reports "AUC considering TPR larger than 0.8": the area between
  the ROC curve and the TPR=0.8 line, i.e. ``integral max(TPR(f)-0.8, 0) df``
  over FPR in [0,1] — maximum attainable value 0.2.
"""

from __future__ import annotations

import numpy as np


def roc_curve(scores, labels):
    """Standard ROC sweep.

    Returns ``(fpr, tpr, thresholds)`` with (0,0) and (1,1) endpoints.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(-scores, kind="stable")
    s, y = scores[order], labels[order]
    P = max(int(y.sum()), 1)
    N = max(int((~y).sum()), 1)
    tp = np.cumsum(y)
    fp = np.cumsum(~y)
    # collapse threshold ties: keep last index of each distinct score
    distinct = np.r_[s[1:] != s[:-1], True]
    tpr = np.r_[0.0, tp[distinct] / P]
    fpr = np.r_[0.0, fp[distinct] / N]
    thr = np.r_[np.inf, s[distinct]]
    return fpr, tpr, thr


def auc(fpr, tpr) -> float:
    """Trapezoidal area under an ROC curve."""
    return float(np.trapezoid(tpr, fpr))


def partial_auc_above_tpr(fpr, tpr, tpr_floor: float = 0.8) -> float:
    """Paper Table I metric: area of the ROC region above ``tpr_floor``.

    ``integral_0^1 max(TPR(f) - tpr_floor, 0) dFPR``; max value
    ``1 - tpr_floor``.
    """
    f = np.asarray(fpr, dtype=np.float64)
    t = np.clip(np.asarray(tpr, dtype=np.float64) - tpr_floor, 0.0, None)
    return float(np.trapezoid(t, f))


def tpr_at_fpr(fpr, tpr, target_fpr: float) -> float:
    """Maximum TPR achievable at FPR <= target (paper Fig. 15 heatmaps)."""
    f = np.asarray(fpr)
    t = np.asarray(tpr)
    ok = f <= target_fpr + 1e-12
    return float(t[ok].max()) if ok.any() else 0.0


def threshold_at_fpr(fpr, tpr, thr, target_fpr: float) -> float:
    """Score threshold realizing the max-TPR operating point at target FPR."""
    f = np.asarray(fpr)
    ok = np.where(f <= target_fpr + 1e-12)[0]
    if len(ok) == 0:
        return float("inf")
    best = ok[np.argmax(np.asarray(tpr)[ok])]
    return float(np.asarray(thr)[best])


def f1_score(pred, labels) -> float:
    pred = np.asarray(pred).astype(bool)
    labels = np.asarray(labels).astype(bool)
    tp = int((pred & labels).sum())
    fp = int((pred & ~labels).sum())
    fn = int((~pred & labels).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def confusion(pred, labels) -> dict:
    pred = np.asarray(pred).astype(bool)
    labels = np.asarray(labels).astype(bool)
    return {
        "tp": int((pred & labels).sum()),
        "fp": int((pred & ~labels).sum()),
        "tn": int((~pred & ~labels).sum()),
        "fn": int((~pred & labels).sum()),
    }
