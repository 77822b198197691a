"""PyTorch port, Table I's baselines (``sensing/baselines.py``) and the two
leftovers ``encoding.encode_frames`` and ``adc.low_precision_view``, each
held against the JAX package on the CPU.

Weights are numpy trees in the reference's layout, carried across by
``convert.baseline_from_arrays`` (dense ``(n_in, n_out)``, HWIO kernels)
and read back by :func:`to_reference`. Frames, fragments and labels come
from ``np.random.default_rng``; ``jax.random`` only draws the reference's
initial weights' shapes (``jax.eval_shape``) and its epoch
permutations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FRAG, STRIDE, model_arrays, t
from repro.core import encoding as jenc
from repro.sensing import adc as jadc
from repro.sensing import baselines as jb
from repro.train import optim as jo
from repro_torch.convert import baseline_from_arrays
from repro_torch.core import encoding as tenc
from repro_torch.core import metrics
from repro_torch.models.common import leaves
from repro_torch.sensing import adc as tadc
from repro_torch.sensing import baselines as tb
from repro_torch.train import optim as to

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

HIDDEN, CHANNELS = 16, (4, 8)
SIZES = (16, 13)                 # 13 is odd: every pool floors
KINDS = ("mlp2", "mlp4", "tiny_conv")
APPLY = {"mlp": (jb.mlp_apply, tb.mlp_apply),
         "tiny_conv": (jb.tiny_conv_apply, tb.tiny_conv_apply)}
LOGIT_RTOL = 1e-5                # of the largest |logit|


def kind_of(name: str) -> str:
    return "tiny_conv" if name == "tiny_conv" else "mlp"


def ref_tree(name: str, size: int, seed: int = 0):
    """The reference's parameter tree as numpy, He-scaled weights and
    (unlike a fresh init) non-zero biases, so the bias path is held too."""
    rng = np.random.default_rng(seed)

    def leaf(shape, fan_in):
        return {"w": (np.sqrt(2.0 / fan_in) * rng.standard_normal(shape)
                      ).astype(np.float32),
                "b": (0.1 * rng.standard_normal(shape[-1])).astype(
                    np.float32)}

    if name == "tiny_conv":
        cins = (1, *CHANNELS[:-1])
        return {"convs": [leaf((3, 3, a, b), 9 * a)
                          for a, b in zip(cins, CHANNELS)],
                "head": leaf((CHANNELS[-1], 2), CHANNELS[-1])}
    n_layers = int(name[-1])
    sizes = [size * size] + [HIDDEN] * (n_layers - 1) + [2]
    return [leaf((a, b), a) for a, b in zip(sizes[:-1], sizes[1:])]


def to_reference(module):
    """The inverse of ``baseline_from_arrays``: the module's parameters
    as the reference's numpy tree."""
    def dense(d):
        return {"w": d["w"].detach().numpy().T, "b": d["b"].detach().numpy()}

    tree = module.tree()
    if isinstance(module, tb.TinyConv):
        return {"convs": [{"w": np.transpose(c["w"].detach().numpy(),
                                             (2, 3, 1, 0)),
                           "b": c["b"].detach().numpy()}
                          for c in tree["convs"]],
                "head": dense(tree["head"])}
    return [dense(layer) for layer in tree]


def both(name: str, size: int, seed: int = 0):
    tree = ref_tree(name, size, seed)
    return (jax.tree.map(jnp.asarray, tree),
            baseline_from_arrays(tree, kind=kind_of(name), device="cpu"))


def fragments(seed: int, n: int, size: int):
    """``(n, size, size)`` fragments in [0, 1.5] (4-bit noise) and labels:
    every other one carries a Gaussian blob at a random place."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 0.8, (n, size, size))
    labels = (np.arange(n) % 2).astype(np.int32)
    yy, xx = np.mgrid[:size, :size]
    for i in np.flatnonzero(labels):
        cy, cx = rng.uniform(3, size - 3, 2)
        x[i] += 0.3 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    x = np.round(np.clip(x, 0.0, 1.5) / 0.1) * 0.1
    return x.astype(np.float32), labels


def logits_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * scale)


def tree_close(module, ref, rtol, atol):
    for p, r in zip(jax.tree.leaves(to_reference(module)),
                    jax.tree.leaves(ref)):
        assert p.shape == np.shape(r)
        np.testing.assert_allclose(p, np.asarray(r), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# forward, loss, gradients, one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", KINDS)
def test_forward_matches_reference(name, size):
    pj, mt = both(name, size)
    x, _ = fragments(1, 10, size)
    apply_j, apply_t = APPLY[kind_of(name)]
    got = apply_t(mt, t(x))
    assert got.shape == (10, 2) and got.dtype == torch.float32
    logits_close(got, apply_j(pj, jnp.asarray(x)))
    np.testing.assert_allclose(
        tb.positive_score(apply_t, mt, t(x)).numpy(),
        np.asarray(jb.positive_score(apply_j, pj, jnp.asarray(x))),
        rtol=0, atol=2 * LOGIT_RTOL * float(got.detach().abs().max()))


def test_carried_weights_round_trip():
    for name in KINDS:
        tree = ref_tree(name, 13)
        back = to_reference(baseline_from_arrays(tree, kind=kind_of(name),
                                                 device="cpu"))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown baseline kind"):
        baseline_from_arrays(ref_tree("mlp2", 13), kind="yolo", device="cpu")
    bad = ref_tree("tiny_conv", 13)
    bad["convs"][1]["w"] = bad["convs"][1]["w"][:, :, :2]    # cin 2, not 4
    with pytest.raises(ValueError, match="does not fit"):
        baseline_from_arrays(bad, kind="tiny_conv", device="cpu")


@pytest.mark.parametrize("name", KINDS)
def test_xent_and_its_gradient_match_reference(name):
    pj, mt = both(name, 13)
    x, y = fragments(2, 12, 13)
    apply_j, apply_t = APPLY[kind_of(name)]
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jb._xent(apply_j(p, jnp.asarray(x)), jnp.asarray(y)))(pj)
    loss_t = tb._xent(apply_t(mt, t(x)), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-6)
    grads = torch.autograd.grad(loss_t, leaves(mt.tree()))
    # each gradient in the reference's layout
    for g, r in zip(grads, jax.tree.leaves(grads_j)):
        g = g.numpy()
        if g.ndim == 2:
            g = g.T
        elif g.ndim == 4:
            g = np.transpose(g, (2, 3, 1, 0))
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(g, np.asarray(r), rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("name", KINDS)
def test_training_step_matches_reference(name):
    """Three steps of ``train_step`` against the reference's step built from
    its public pieces (``optim.AdamW``, ``baselines._xent``,
    ``jax.value_and_grad``, ``optim.apply_updates``)."""
    pj, mt = both(name, 13)
    apply_j, apply_t = APPLY[kind_of(name)]
    opt_j = jo.AdamW(lr=1e-3, weight_decay=1e-4)
    opt_t = to.AdamW(lr=1e-3, weight_decay=1e-4)
    sj, st = opt_j.init(pj), opt_t.init(mt.tree())

    @jax.jit
    def step(p, s, xb, yb):
        loss, grads = jax.value_and_grad(
            lambda q: jb._xent(apply_j(q, xb), yb))(p)
        updates, s = opt_j.update(grads, s, p)
        return jo.apply_updates(p, updates), s, loss

    for i in range(3):
        x, y = fragments(10 + i, 16, 13)
        pj, sj, loss_j = step(pj, sj, jnp.asarray(x), jnp.asarray(y))
        st, loss_t = tb.train_step(mt, apply_t, opt_t, st, t(x),
                                   torch.from_numpy(y))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        tree_close(mt, pj, rtol=1e-5, atol=1e-6)
    assert int(st.step) == 3


@pytest.mark.parametrize("name", ["mlp2", "tiny_conv"])
def test_train_classifier_whole_run_at_one_batch(name):
    """``n == batch_size``: every epoch is one step on the whole set, so
    the reference's ``jax.random`` permutation only reorders a mean and
    the two runs differ by rounding alone. Held-out scores within 1e-3,
    AUC within 0.005 (measured on a CPU: scores within 2.1e-7 (MLP2) and
    6.6e-7 (TinyConv) of scores up to 0.52, AUC 0.660 and 0.7225 in
    both)."""
    pj, mt = both(name, 13, seed=3)
    x, y = fragments(20, 32, 13)
    xt, yt = fragments(21, 40, 13)
    apply_j, apply_t = APPLY[kind_of(name)]
    trained_j = jb.train_classifier(jax.random.PRNGKey(0), pj, apply_j,
                                    jnp.asarray(x), jnp.asarray(y),
                                    epochs=12, batch_size=32, lr=1e-2)
    trained_t = tb.train_classifier(torch.Generator().manual_seed(0), mt,
                                    apply_t, x, y, epochs=12, batch_size=32,
                                    lr=1e-2)
    assert trained_t is not mt
    tree_close(mt, pj, rtol=0, atol=0)        # the input is left as it was
    sj = np.asarray(jb.positive_score(apply_j, trained_j, jnp.asarray(xt)))
    st = tb.positive_score(apply_t, trained_t, t(xt)).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-3)
    auc_j = metrics.auc(*metrics.roc_curve(sj, yt)[:2])
    auc_t = metrics.auc(*metrics.roc_curve(st, yt)[:2])
    assert abs(auc_t - auc_j) <= 0.005
    # it learned: the training loss fell
    with torch.no_grad():
        before = float(tb._xent(apply_t(mt, t(x)), torch.from_numpy(y)))
        after = float(tb._xent(apply_t(trained_t, t(x)),
                               torch.from_numpy(y)))
    assert after < before


def test_train_classifier_batches_and_generator():
    """``max(n // batch_size, 1)`` steps an epoch from one ``randperm`` an
    epoch: the same seed gives the same bits, another seed other bits."""
    _, mt = both("mlp2", 13)
    x, y = fragments(30, 40, 13)

    def train(seed, **kw):
        return tb.train_classifier(torch.Generator().manual_seed(seed), mt,
                                   tb.mlp_apply, x, y, epochs=3, **kw)

    a, b, c = train(0, batch_size=16), train(0, batch_size=16), \
        train(1, batch_size=16)
    assert all(torch.equal(p, q) for p, q in zip(leaves(a.tree()),
                                                  leaves(b.tree())))
    assert not all(torch.equal(p, q) for p, q in zip(leaves(a.tree()),
                                                      leaves(c.tree())))
    # a batch larger than the set: one step an epoch on the whole set, in
    # the order of the epoch's permutation
    whole = tb.train_classifier(torch.Generator().manual_seed(0), mt,
                                tb.mlp_apply, x, y, epochs=1, batch_size=64)
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(0))
    opt = to.AdamW(lr=1e-3, weight_decay=1e-4)
    step = baseline_from_arrays(to_reference(mt), kind="mlp", device="cpu")
    tb.train_step(step, tb.mlp_apply, opt, opt.init(step.tree()),
                  t(x)[perm], torch.from_numpy(y).long()[perm])
    assert all(torch.equal(p, q) for p, q in zip(leaves(whole.tree()),
                                                  leaves(step.tree())))


# ---------------------------------------------------------------------------
# init statistics and the device rule
# ---------------------------------------------------------------------------

def test_init_shapes_zero_biases_and_scale():
    g = torch.Generator().manual_seed(5)
    for n_layers in (2, 4):
        m = tb.init_mlp(g, 1024, hidden=256, n_layers=n_layers)
        ref = jax.eval_shape(lambda: jb.init_mlp(
            jax.random.PRNGKey(0), 1024, n_layers=n_layers))
        for layer, r in zip(m.tree(), ref):
            assert tuple(layer["w"].shape) == r["w"].shape[::-1]
            assert layer["b"].shape == r["b"].shape
            assert not layer["b"].any()
            fan_in = r["w"].shape[0]
            assert float(layer["w"].detach().std()) == pytest.approx(
                np.sqrt(2.0 / fan_in), rel=0.15)
            assert layer["w"].device.type == "cpu"
    m = tb.init_tiny_conv(g)
    ref = jax.eval_shape(lambda: jb.init_tiny_conv(jax.random.PRNGKey(0)))
    for conv, r in zip(m.tree()["convs"], ref["convs"]):
        kh, kw, cin, cout = r["w"].shape
        assert tuple(conv["w"].shape) == (cout, cin, kh, kw)
        assert not conv["b"].any()
        fan_in = 9 * conv["w"].shape[1]
        assert float(conv["w"].detach().std()) == pytest.approx(
            np.sqrt(2.0 / fan_in), rel=0.25)
    assert tuple(m.tree()["head"]["w"].shape) == (2, 64)
    # one seed, one set of weights
    a = tb.init_mlp(torch.Generator().manual_seed(1), 64, 16)
    b = tb.init_mlp(torch.Generator().manual_seed(1), 64, 16)
    assert all(torch.equal(p, q) for p, q in zip(leaves(a.tree()),
                                                  leaves(b.tree())))


def test_device_rule():
    """``device=None`` means the card, and raises on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        baseline_from_arrays(ref_tree("mlp2", 13), kind="mlp")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.MLP([4, 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.TinyConv((4,))


# ---------------------------------------------------------------------------
# encode_frames and low_precision_view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rff", "linear", "sign"])
@pytest.mark.parametrize("reuse", [True, False])
def test_encode_frames_matches_reference(reuse, kind):
    _, B0, b = model_arrays(6, 128)
    frames = np.random.default_rng(7).uniform(0, 1.5, (3, 24, 28)).astype(
        np.float32)
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE, nonlinearity=kind)
    got = tenc.encode_frames(t(frames), t(B0), t(b), reuse=reuse, **kw)
    want = np.asarray(jenc.encode_frames(jnp.asarray(frames),
                                         jnp.asarray(B0), jnp.asarray(b),
                                         reuse=reuse, **kw))
    assert got.shape == want.shape == (3, 5, 6, 128)
    # test_torch_core's tolerances: the reuse encoder's prefix sums round
    # differently in the two packages (1e-5); no projection here sits
    # within that of 0, so the signs agree exactly
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 if reuse else 1e-6)
    for i in range(3):          # each frame as its own encoder gives it
        fn = tenc.encode_frame_reuse if reuse else tenc.encode_frame_naive
        assert torch.equal(got[i], fn(t(frames[i]), t(B0), t(b), **kw))


def test_low_precision_view():
    frame = np.random.default_rng(8).uniform(-0.2, 1.7, (2, 9, 11)).astype(
        np.float32)
    for bits in (2, 4, 8):
        got = tadc.low_precision_view(
            t(frame), bits, 0.0, generator=torch.Generator().manual_seed(0))
        want = jadc.low_precision_view(jax.random.PRNGKey(0),
                                       jnp.asarray(frame), bits, 0.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def view(seed):
        return tadc.low_precision_view(
            t(frame), generator=torch.Generator().manual_seed(seed))

    a, b, c = view(3), view(3), view(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # on the 4-bit grid of [0, 1.5]
    codes = a / tadc.lsb(4)
    assert torch.allclose(codes, codes.round(), atol=1e-4)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.5
    with pytest.raises(ValueError, match="generator"):
        tadc.low_precision_view(torch.zeros((2, 4), device="meta"),
                                generator=torch.Generator())
