"""PyTorch port, ``train/optim.py``: AdamW, SGD, the global-norm clip,
``apply_updates`` and the three schedules, each held against
``repro.train.optim`` on the CPU on the same numpy trees.

The two packages do not agree bit for bit: XLA's CPU ``pow`` and ``sqrt``
and its order of summation differ from PyTorch's by an ulp here and
there, so the updates are held at rtol 1e-6 / atol 1e-7 (an update is
~1e-3 to 1e-2, so 1e-7 is ~1e-5 of it at the smallest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as jo
from repro_torch.models.common import leaves
from repro_torch.train import optim as to

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
SHAPES = [{"w": (5, 3), "b": (3,)}, {"w": (3, 2), "b": (2,)},
          {"w": (2, 4, 2), "b": (2,)}]
STEPS = 10


def tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return [{k: (scale * rng.standard_normal(s)).astype(np.float32)
             for k, s in layer.items()} for layer in SHAPES]


def to_jax(tr):
    return jax.tree.map(jnp.asarray, tr)


def to_torch(tr):
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
            for layer in tr]


def close(port, ref, rtol=RTOL, atol=ATOL):
    """Port tree against reference tree, leaf by leaf in the reference's
    order (``leaves`` visits keys sorted, as ``jax.tree.leaves``)."""
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = leaves(port) if not isinstance(port, torch.Tensor) \
        else [port]
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        assert p.shape == r.shape and p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


def schedules(pkg):
    return {"float": 1e-2, "cosine": pkg.warmup_cosine(1e-2, 3, STEPS),
            "linear": pkg.warmup_linear(1e-2, 3, STEPS),
            "constant": pkg.constant(1e-2)}


def run(opt_j, opt_t, grad_scale: float):
    """``STEPS`` updates in both packages on the same gradients; the
    updates, moments and parameters of every step compared."""
    pj, pt = to_jax(tree(0)), to_torch(tree(0))
    sj, st = opt_j.init(pj), opt_t.init(pt)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for i in range(STEPS):
        g = tree(100 + i, grad_scale)
        uj, sj = opt_j.update(to_jax(g), sj, pj)
        ut, st = opt_t.update(to_torch(g), st, pt)
        close(ut, uj)
        pj, pt = jo.apply_updates(pj, uj), to.apply_updates(pt, ut)
        close(pt, pj)
        assert int(st.step) == int(sj.step) == i + 1
    return sj, st


@pytest.mark.parametrize("lr", ["float", "cosine"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_matches_reference(clip, weight_decay, lr):
    # gradients of global norm ~30 are clipped to 1.0; ~0.03 are not
    scale = 5.0 if clip == "active" else 0.005
    g = tree(100, scale)
    norm = float(jo.global_norm(to_jax(g)))
    assert (norm > 1.0) == (clip == "active")
    sj, st = run(jo.AdamW(lr=schedules(jo)[lr], weight_decay=weight_decay),
                 to.AdamW(lr=schedules(to)[lr], weight_decay=weight_decay),
                 scale)
    close(st.mu, sj.mu)
    close(st.nu, sj.nu, atol=1e-10)


def test_adamw_defaults_and_no_clip():
    assert to.AdamW() == to.AdamW(1e-3, 0.9, 0.95, 1e-8, 0.0, 1.0)
    assert tuple(to.AdamW()) == tuple(jo.AdamW())
    run(jo.AdamW(lr=3e-3, clip_norm=None), to.AdamW(lr=3e-3, clip_norm=None),
        5.0)


def test_adamw_casts_updates_to_the_param_dtype():
    p = {"a": torch.ones(3, dtype=torch.bfloat16)}
    opt = to.AdamW(lr=0.1)
    u, _ = opt.update({"a": torch.ones(3, dtype=torch.bfloat16)},
                      opt.init(p), p)
    assert u["a"].dtype == torch.bfloat16


@pytest.mark.parametrize("lr", ["float", "linear", "constant"])
@pytest.mark.parametrize("clip_norm", [None, 1.0])
def test_sgd_matches_reference(clip_norm, lr):
    sj, st = run(jo.SGD(lr=schedules(jo)[lr], clip_norm=clip_norm),
                 to.SGD(lr=schedules(to)[lr], clip_norm=clip_norm), 5.0)
    close(st.momentum, sj.momentum)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_global_norm_clip_and_apply_updates(scale):
    g = tree(7, scale)
    gj, gt = to_jax(g), to_torch(g)
    np.testing.assert_allclose(float(to.global_norm(gt)),
                               float(jo.global_norm(gj)), rtol=RTOL)
    for max_norm in (0.5, 1.0, 1e3):
        close(to.clip_by_global_norm(gt, max_norm),
              jo.clip_by_global_norm(gj, max_norm))
    # the clipped tree's norm is min(norm, max_norm)
    norm = float(to.global_norm(gt))
    np.testing.assert_allclose(
        float(to.global_norm(to.clip_by_global_norm(gt, 1.0))),
        min(norm, 1.0), rtol=1e-5)
    p = tree(8)
    close(to.apply_updates(to_torch(p), gt),
          jo.apply_updates(to_jax(p), gj))
    # an all-zero tree: the clip keeps it zero (norm floored at 1e-12)
    z = to.clip_by_global_norm([{"a": torch.zeros(4)}], 1.0)
    assert torch.equal(z[0]["a"], torch.zeros(4))


def test_tree_order_is_the_references():
    """Dict keys are visited sorted, lists in order, as ``jax.tree``."""
    tr = {"z": [torch.tensor(1.0), {"y": torch.tensor(2.0),
                                    "a": torch.tensor(3.0)}],
          "b": torch.tensor(4.0)}
    ref = {"z": [1.0, {"y": 2.0, "a": 3.0}], "b": 4.0}
    assert [float(x) for x in leaves(tr)] == jax.tree.leaves(ref)
    doubled = to.apply_updates(tr, tr)
    assert [float(x) for x in leaves(doubled)] == [8.0, 2.0, 6.0, 4.0]


WARMUP, TOTAL = 4, 20
STEPS_AT = [0, 1, WARMUP - 1, WARMUP, (WARMUP + TOTAL) // 2, TOTAL,
            TOTAL + 5]


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear",
                                  "constant"])
def test_schedules_match_reference(name):
    args = (3e-3,) if name == "constant" else (3e-3, WARMUP, TOTAL)
    sj, st = getattr(jo, name)(*args), getattr(to, name)(*args)
    for s in STEPS_AT:
        got = st(torch.tensor(s, dtype=torch.int32))
        want = sj(jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=1e-10)
    if name != "constant":
        assert float(st(torch.tensor(WARMUP, dtype=torch.int32))) == \
            pytest.approx(3e-3)
