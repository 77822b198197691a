"""PyTorch port, the training path held against the JAX package on the
CPU: fragment sampling and every ROC metric exactly, bundling, retraining
(identical accuracy history and best epoch), the positive score, and the
whole slice (sample -> train -> held-out scores -> AUC -> frame scores of
``from_fragment_model``) for the permutation and the i.i.d. base.

Training draws its base inside ``train_fragment_model`` (a JAX key on one
side, a ``torch.Generator`` on the other), so the whole-slice tests patch
both packages' base makers to return the same numpy arrays. Retraining is
order-sensitive (each step's argmax decides whether the classifier
moves), so every trajectory compared here is first checked to keep its
decisions clear of a tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SCORE_ATOL, t
from repro.core import encoding as jenc
from repro.core import fragment_model as jfm
from repro.core import hypersense as jhs
from repro.core import metrics as jmet
from repro.sensing import fragments as jfrag
from repro_torch.convert import fragment_model_from_arrays
from repro_torch.core import encoding as tenc
from repro_torch.core import fragment_model as tfm
from repro_torch.core import hdc as thdc
from repro_torch.core import hypersense as ths
from repro_torch.core import metrics as tmet
from repro_torch.core import online as tonline
from repro_torch.sensing import fragments as tfrag

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

#: 32x32 frames, 8x8 fragments, stride 4 (7x7 windows), D=256
SIZE, FRAG, STRIDE, DIM = 32, 8, 4, 256
#: every argmax a compared trajectory takes must clear a tie by this much
TIE_MARGIN = 1e-5
#: a positive/negative score pair this close may order differently
AUC_PAIR_GAP = 1e-4


def close(a, b, atol=SCORE_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def frames_and_masks(seed, n):
    """``(n, 32, 32)`` frames in [0, 1.5] with a Gaussian blob on every
    other pair of frames, its ``> 0.5`` mask, and the frame labels."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0.0, 0.6, (n, SIZE, SIZE))
    masks = np.zeros((n, SIZE, SIZE), np.float32)
    labels = (np.arange(n) // 2) % 2
    yy, xx = np.mgrid[:SIZE, :SIZE]
    for i in np.flatnonzero(labels):
        cy, cx = rng.uniform(6, SIZE - 6, 2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
        frames[i] += 0.9 * blob
        masks[i] = blob > 0.5
    return (np.clip(frames, 0.0, 1.5).astype(np.float32), masks,
            labels.astype(np.int32))


def fragment_sets(seed):
    ftr, mtr, _ = frames_and_masks(seed, 24)
    fte, mte, _ = frames_and_masks(seed + 1, 16)
    tr = jfrag.sample_fragments(ftr, mtr, h=FRAG, w=FRAG, per_frame=2,
                                seed=0)
    te = jfrag.sample_fragments(fte, mte, h=FRAG, w=FRAG, per_frame=3,
                                seed=1)
    return tr, te


def trajectory_margin(class_hvs, hvs, labels, epochs, lr, val_hvs):
    """Smallest |s_1 - s_0| any retraining step or validation prediction
    sees along the port's trajectory."""
    m = float("inf")
    for _ in range(epochs):
        for i in range(hvs.shape[0]):
            s = thdc.class_scores(hvs[i][None], class_hvs)[0]
            m = min(m, float(abs(s[1] - s[0])))
            class_hvs, _ = tonline.online_update(class_hvs, hvs[i],
                                                 labels[i], lr)
        s = thdc.class_scores(val_hvs, class_hvs)
        m = min(m, float((s[:, 1] - s[:, 0]).abs().min()))
    return m


def assert_same_auc(scores, labels, want_auc):
    """The AUC is the share of positive/negative pairs in order. With every
    score within ``SCORE_ATOL`` of the reference's, only a pair closer than
    ``AUC_PAIR_GAP`` can order differently: the AUC is equal when there is
    none, and otherwise moves by at most those pairs' share."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels).astype(bool)
    gaps = np.abs(s[y][:, None] - s[~y][None, :])
    n_close = int((gaps <= AUC_PAIR_GAP).sum())
    fpr, tpr, _ = tmet.roc_curve(s, y)
    assert abs(tmet.auc(fpr, tpr) - want_auc) <= n_close / gaps.size


# ---------------------------------------------------------------------------
# fragments and metrics: numpy copies, equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_frame,seed", [(1, 0), (2, 3), (3, 7)])
def test_sample_fragments_equal(per_frame, seed):
    frames, masks, _ = frames_and_masks(seed, 12)
    want = jfrag.sample_fragments(frames, masks, h=FRAG, w=FRAG,
                                  per_frame=per_frame, seed=seed)
    got = tfrag.sample_fragments(frames, masks, h=FRAG, w=FRAG,
                                 per_frame=per_frame, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 1).sum() == (got[1] == 0).sum() > 0


def test_metrics_equal():
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 2, 200)
    scores = np.round(rng.standard_normal(200) + labels, 1)  # with ties
    jr, tr = jmet.roc_curve(scores, labels), tmet.roc_curve(scores, labels)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a, b)
    fpr, tpr, thr = tr
    assert tmet.auc(fpr, tpr) == jmet.auc(fpr, tpr)
    for floor in (0.5, 0.8):
        assert tmet.partial_auc_above_tpr(fpr, tpr, floor) == \
            jmet.partial_auc_above_tpr(fpr, tpr, floor)
    for target in (0.0, 0.05, 0.2, 1.0):
        assert tmet.tpr_at_fpr(fpr, tpr, target) == \
            jmet.tpr_at_fpr(fpr, tpr, target)
        assert tmet.threshold_at_fpr(fpr, tpr, thr, target) == \
            jmet.threshold_at_fpr(fpr, tpr, thr, target)
    assert tmet.threshold_at_fpr(fpr[1:], tpr[1:], thr[1:], -1.0) == \
        jmet.threshold_at_fpr(fpr[1:], tpr[1:], thr[1:], -1.0)
    pred = scores > 0.5
    assert tmet.f1_score(pred, labels) == jmet.f1_score(pred, labels)
    assert tmet.f1_score(pred & False, labels & 0) == 0.0
    assert tmet.confusion(pred, labels) == jmet.confusion(pred, labels)


# ---------------------------------------------------------------------------
# bundling, scoring, retraining
# ---------------------------------------------------------------------------

def encoded_sets(seed):
    """Held-out and training hypervectors of one perm base, as numpy."""
    (ftr, ltr), (fte, lte) = fragment_sets(seed)
    rng = np.random.default_rng(seed + 100)
    B0 = rng.standard_normal((FRAG, DIM)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, DIM).astype(np.float32)
    B = np.asarray(jenc.flat_perm_base(jnp.asarray(B0), FRAG))
    enc = tenc.encode_fragments
    return (enc(t(ftr), t(B), t(b)).numpy(), ltr,
            enc(t(fte), t(B), t(b)).numpy(), lte)


def test_bundle_init_and_positive_score():
    hv, lab, hv_te, _ = encoded_sets(20)
    want = jfm.bundle_init(jnp.asarray(hv), jnp.asarray(lab))
    got = tfm.bundle_init(t(hv), t(lab))
    scale = float(np.abs(np.asarray(want)).max())
    close(got, want, 1e-5 * scale)
    close(tfm.positive_score(got, t(hv_te)),
          jfm.positive_score(want, jnp.asarray(hv_te)))
    close(tfm.scores(got, t(hv_te)), jfm.scores(want, jnp.asarray(hv_te)))
    np.testing.assert_array_equal(
        tfm.predict(got, t(hv_te)).numpy(),
        np.asarray(jfm.predict(want, jnp.asarray(hv_te))))


@pytest.mark.parametrize("lr", [1.0, 0.5])
def test_retrain_matches_jax(lr):
    hv, lab, hv_te, lte = encoded_sets(30)
    chvs = tfm.bundle_init(t(hv), t(lab))
    epochs = 4
    assert trajectory_margin(chvs, t(hv), t(lab).long(), epochs, lr,
                             t(hv_te)) > TIE_MARGIN
    # one epoch
    want1 = jfm.retrain_epoch(jnp.asarray(chvs.numpy()), jnp.asarray(hv),
                              jnp.asarray(lab), lr)
    got1 = tfm.retrain_epoch(chvs, t(hv), t(lab).long(), lr)
    scale = float(np.abs(np.asarray(want1)).max())
    close(got1, want1, 1e-4 * scale)
    # best-epoch selection on the held-out set
    jm = jfm.FragmentModel(jnp.asarray(chvs.numpy()), jnp.zeros(1),
                           jnp.zeros(1))
    tm = tfm.FragmentModel(chvs, torch.zeros(1), torch.zeros(1))
    jm, jinfo = jfm.retrain(jm, jnp.asarray(hv), jnp.asarray(lab),
                            epochs=epochs, lr=lr,
                            val_hvs=jnp.asarray(hv_te),
                            val_labels=jnp.asarray(lte))
    tm, tinfo = tfm.retrain(tm, t(hv), t(lab).long(), epochs=epochs, lr=lr,
                            val_hvs=t(hv_te), val_labels=t(lte).long())
    assert tinfo == jinfo
    assert len(set(tinfo["val_accuracy"])) > 1  # selection is not vacuous
    scale = float(np.abs(np.asarray(jm.class_hvs)).max())
    close(tm.class_hvs, jm.class_hvs, 1e-4 * scale)


def test_fragment_model_round_trip_scores_the_same():
    hv, lab, hv_te, _ = encoded_sets(40)
    rng = np.random.default_rng(41)
    B = rng.standard_normal((FRAG * FRAG, DIM)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, DIM).astype(np.float32)
    jm = jfm.FragmentModel(jfm.bundle_init(jnp.asarray(hv),
                                           jnp.asarray(lab)),
                           jnp.asarray(B), jnp.asarray(b))
    tm = fragment_model_from_arrays(np.asarray(jm.class_hvs),
                                    np.asarray(jm.B), np.asarray(jm.b),
                                    device="cpu")
    for f in ("class_hvs", "B", "b"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    close(tfm.positive_score(tm.class_hvs, t(hv_te)),
          jfm.positive_score(jm.class_hvs, jnp.asarray(hv_te)))
    (_, _), (fte, _) = fragment_sets(40)
    close(tfm.encode(tm, t(fte)),
          jenc.encode_fragments(jnp.asarray(fte), jm.B, jm.b), 1e-4)
    with pytest.raises(ValueError, match="share one D"):
        fragment_model_from_arrays(np.asarray(jm.class_hvs), B[:, 1:],
                                   b[1:], device="cpu")


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base_kind", ["perm", "iid"])
def test_whole_training_slice_matches_jax(base_kind, monkeypatch):
    (ftr, ltr), (fte, lte) = fragment_sets(50)
    rng = np.random.default_rng(51)
    rows = FRAG if base_kind == "perm" else FRAG * FRAG
    base = rng.standard_normal((rows, DIM)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, DIM).astype(np.float32)
    maker = ("make_perm_base_rows" if base_kind == "perm"
             else "make_iid_base")
    monkeypatch.setattr(jenc, maker, lambda key, n, dim: (
        jnp.asarray(base), jnp.asarray(phase)))
    monkeypatch.setattr(tenc, maker, lambda gen, n, dim: (
        t(base), t(phase)))
    epochs = 5
    kw = dict(dim=DIM, epochs=epochs, base_kind=base_kind,
              val_frags=fte, val_labels=lte)

    # the port's trajectory keeps its decisions clear of a tie
    B = (tenc.flat_perm_base(t(base), FRAG) if base_kind == "perm"
         else t(base))
    hv = tenc.encode_fragments(t(ftr), B, t(phase))
    hv_te = tenc.encode_fragments(t(fte), B, t(phase))
    assert trajectory_margin(tfm.bundle_init(hv, t(ltr)), hv,
                             t(ltr).long(), epochs, 1.0,
                             hv_te) > TIE_MARGIN

    jm, jinfo = jfm.train_fragment_model(jax.random.PRNGKey(0),
                                         jnp.asarray(ftr), jnp.asarray(ltr),
                                         **kw)
    tm, tinfo = tfm.train_fragment_model(torch.Generator(), ftr, ltr,
                                         device="cpu", **kw)
    assert tinfo == jinfo
    np.testing.assert_array_equal(tm.B.numpy(), np.asarray(jm.B))
    np.testing.assert_array_equal(tm.b.numpy(), np.asarray(jm.b))
    scale = float(np.abs(np.asarray(jm.class_hvs)).max())
    close(tm.class_hvs, jm.class_hvs, 1e-4 * scale)

    # held-out fragment scores and their AUC
    j_scores = np.asarray(jfm.positive_score(
        jm.class_hvs, jenc.encode_fragments(jnp.asarray(fte), jm.B, jm.b)))
    t_scores = tfm.positive_score(tm.class_hvs, tfm.encode(tm, t(fte)))
    close(t_scores, j_scores)
    fpr, tpr, _ = jmet.roc_curve(j_scores, lte)
    assert jmet.auc(fpr, tpr) > 0.7, "the synthetic task must be learnable"
    assert_same_auc(t_scores.numpy(), lte, jmet.auc(fpr, tpr))

    # the frame model built from it scores held-out frames the same
    frames, _, flabels = frames_and_masks(52, 12)
    B0 = np.asarray(jm.B).reshape(FRAG, FRAG, -1)[:, 0, :]
    jhsm = jhs.from_fragment_model(jm, jnp.asarray(B0), h=FRAG, w=FRAG,
                                   stride=STRIDE)
    thsm = ths.from_fragment_model(tm, t(B0), h=FRAG, w=FRAG, stride=STRIDE)
    assert (thsm.h, thsm.w, thsm.stride, thsm.t_score, thsm.t_detection,
            thsm.nonlinearity) == (jhsm.h, jhsm.w, jhsm.stride,
                                   jhsm.t_score, jhsm.t_detection,
                                   jhsm.nonlinearity)
    want = np.asarray(jhs.frame_scores_batch(jhsm, jnp.asarray(frames), 0,
                                             backend="pallas"))
    got = ths.frame_scores_batch(thsm, t(frames))
    close(got, want)
    fpr, tpr, _ = jmet.roc_curve(want, flabels)
    assert_same_auc(got.numpy(), flabels, jmet.auc(fpr, tpr))
