"""PyTorch port, ``"dots"`` remat: ``repro_torch.models.lm._remat`` keeps
the outputs of the products without batch dims (the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest.

For one smoke config of each family (encoder, dense, vlm, moe, hybrid,
ssm), float32, on the same numpy weights and batch: the loss and every
gradient under "dots" bitwise those under "full" and "none"; within the
family's own CPU bounds (``BOUNDS``: the loss relative, each gradient
leaf of its largest |entry|, as its ``test_torch_lm_*`` /
``test_torch_cells`` parity test holds it) of the reference's
``remat="dots"``; and, counted by a ``TorchDispatchMode`` over the
backward pass, "dots" runs no more ``aten.mm`` there than "none" (the
gradients' own products) while "full" runs the forward's again, and
"dots" recomputes the batched products and the sLSTM's scan op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_cells import np_batch as encoder_batch
from test_torch_lm_dense import np_batch, np_params, rel
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import common, lm

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

#: family -> (arch, weight std, loss rtol, gradient rtol): the weights'
#: scale and bounds of the family's parity tests
BOUNDS = {"encoder": ("hubert-xlarge", 0.2, 1e-6, 1e-5),
          "dense": ("olmo-1b", 0.2, 1e-5, 1e-5),
          "vlm": ("internvl2-76b", 0.2, 1e-5, 1e-5),
          "moe": ("qwen3-moe-235b-a22b", 0.2, 1e-5, 1e-4),
          "hybrid": ("zamba2-1.2b", 0.02, 1e-5, 1e-4),
          "ssm": ("xlstm-350m", 0.02, 1e-5, 1e-4)}
B, S = 2, 32


class OpCount(TorchDispatchMode):
    """Calls of each aten op packet while the mode is on."""

    def __init__(self):
        super().__init__()
        self.n: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def inputs(family, seed=0):
    arch, std, _, _ = BOUNDS[family]
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    assert cfg.family == family and cfg.compute_dtype == "float32"
    arrays = np_params(lm.Model(cfg).spec(), seed, std)
    if cfg.embeds_in:
        jb, tb = encoder_batch(seed + 1, B, S, cfg.d_model, cfg.vocab)
    else:
        jb, tb = np_batch(cfg, seed + 1, B, S)
    return cfg, jcfg, arrays, jb, tb


def run(cfg, arrays, batch, remat):
    """The loss, the gradients and the backward pass's op counts under
    ``remat``."""
    c = cfg.replace(remat=remat)
    params = common.tree_map(lambda a: a.requires_grad_(),
                             lm_params_from_arrays(arrays, cfg=c,
                                                   device="cpu"))
    loss = lm.Model(c).loss(params, batch)
    with OpCount() as count:
        grads = torch.autograd.grad(loss, common.leaves(params))
    return loss.detach(), grads, count.n


@pytest.mark.parametrize("family", list(BOUNDS))
def test_dots_is_bitwise_full_and_none(family):
    cfg, _, arrays, _, tb = inputs(family)
    got = {r: run(cfg, arrays, tb, r) for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert torch.equal(got[r][0], got["none"][0]), r
        assert len(got[r][1]) == len(got["none"][1])
        for a, b in zip(got[r][1], got["none"][1]):
            assert torch.equal(a, b), r


@pytest.mark.parametrize("family", list(BOUNDS))
def test_dots_against_the_reference_dots(family):
    cfg, jcfg, arrays, jb, tb = inputs(family, seed=3)
    _, _, loss_rtol, grad_rtol = BOUNDS[family]
    jmodel = jlm.build(jcfg.replace(remat="dots"))
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb)))(jax.tree.map(jnp.asarray, arrays))
    loss, grads, _ = run(cfg, arrays, tb, "dots")
    assert abs(float(loss) - float(want)) <= loss_rtol * abs(float(want))
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        assert rel(g, w) <= grad_rtol


@pytest.mark.parametrize("family", list(BOUNDS))
def test_dots_recomputes_no_product_without_batch_dims(family):
    """The backward pass's ``mm`` count under "dots" is "none"'s (the
    gradients' products alone), under "full" more (the forward's again);
    "dots" and "full" recompute the batched products (``bmm``) and the
    sLSTM's scan op alike."""
    cfg, _, arrays, _, tb = inputs(family, seed=5)
    n = {r: run(cfg, arrays, tb, r)[2] for r in ("none", "dots", "full")}
    assert n["dots"].get("mm", 0) == n["none"].get("mm", 0) > 0
    assert n["full"].get("mm", 0) > n["none"].get("mm", 0)
    for op in ("bmm", "slstm_scan"):
        assert n["dots"].get(op, 0) == n["full"].get(op, 0) \
            >= n["none"].get(op, 0)
    assert n["dots"].get("bmm", 0) > n["none"].get("bmm", 0)
    if family == "ssm":
        assert n["dots"]["slstm_scan"] > n["none"].get("slstm_scan", 0)
