"""PyTorch port, the moe family of the LM zoo: ``qwen3-moe-235b-a22b`` and
``grok-1-314b`` through ``repro_torch.models``, ``repro_torch.launch.
steps`` and ``launch.decode``, against ``repro.models.lm``,
``repro.launch.steps`` and ``repro.launch.decode`` on the same numpy
inputs (the mirror of ``tests/test_torch_lm_dense.py`` and
``tests/test_torch_decode.py`` for the mixture of experts).

Each architecture's smoke config: ``spec`` and ``param_specs`` against
the reference's ``spec`` and ``param_shardings`` on (1, 1), (8, 1),
(4, 2) and 16x16 meshes, and the full configs' on the production meshes
(grok's 8 experts, which 16 does not divide, split by ``d_ff``);
``Model.forward``'s logits within ``F32_RTOL`` of the largest |logit|;
``Model.loss`` (the NLL plus the experts' auxiliary loss, summed over the
layers) within ``LOSS_RTOL`` relative and each gradient leaf within
``GRAD_RTOL`` of its largest |entry| (``chip_smoke.py``'s float32
CELLS_TOL); one train step from a mid-run AdamW state, its parameters
and moments within ``GRAD_RTOL``; ``Model.decode_step`` over three tokens
from a half-filled bf16 cache (the logits within ``F32_RTOL``, the next
tokens equal, the cache within one bf16 ulp); decode against the port's
own forward at the no-drop capacity (``capacity_factor = E / k``: the
capacity is the call's token count, the decode step's batch or the
prefill's whole batch, so nothing drops in either); ``greedy_decode``
token for token and the launcher's ``main``. Every comparison of a
routing runs behind the precondition that the reference's routing of
every layer has its tokens' k + 1 largest probabilities
``ROUTING_MARGIN`` apart (recorded by ``jax.debug.callback``). The
full configs: ``input_specs`` and the decode cell's ``build_cell`` spec
trees against the reference's, ``analyze()`` term by term and
``model_flops`` and ``active_params`` at ``train_4k``, ``prefill_32k``
and ``decode_32k`` on one device, 1x1, 16x16 and 2x16x16; the smoke
cells' FLOPs on meta tensors against the hand count. The float32 configs
alone are held against the reference: in bf16 the two packages' layer
inputs differ by bf16 rounding, far above any margin a routing can be
held to (the block itself is held in bf16 in ``tests/test_torch_moe.py``).

The weights are drawn at ``WEIGHT_STD`` (norm scales ``1 + 0.1 N``), as
in ``tests/test_torch_lm_dense.py``.
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_parity import within_one_bf16_ulp
from _torch_train_mesh_worker import ROUTING_MARGIN, record_margins
from test_torch_cells import abstract_tree, same_meta, spec_leaves
from test_torch_decode import np_cache
from test_torch_dryrun import moe_flops
from test_torch_lm_dense import (abstract_meshes, np_batch, np_params, rel,
                                 smoke, spec_entries)
from repro import configs as jconfigs
from repro.distributed import memory_model as jmm
from repro.distributed import roofline as jroofline
from repro.launch import decode as jdecode
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch import configs
from repro_torch.convert import (adamw_state_from_arrays,
                                 kv_cache_from_arrays, lm_params_from_arrays)
from repro_torch.distributed import memory_model as mm
from repro_torch.distributed import roofline
from repro_torch.launch import decode, steps
from repro_torch.models import attention, common, lm, mlp

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]
F32_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MID_RUN_STEP = 2400
B, S = 2, 24
#: the decode cache: its length and valid positions
CACHE, INDEX = 32, 13
SPEC_MESHES = {"1x1": (1, 1), "8x1": (8, 1), "4x2": (4, 2),
               "16x16": (16, 16)}
ANALYZE_MESHES = {"one": (), "1x1": (1, 1), "16x16": (16, 16),
                  "2x16x16": (2, 16, 16)}
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@contextlib.contextmanager
def reference_margins():
    """Every routing the reference's ``moe_apply`` makes inside the scope,
    jitted, scanned or differentiated: its least routing margin (the gap
    between neighbours among each token's k + 1 largest probabilities),
    appended to the yielded list once the scope's work has run."""
    seen = []
    orig = jmlp.moe_apply

    def recorded(params, x, cfg):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(
            xf @ params["router"].astype(jnp.float32), axis=-1)
        top = -jnp.sort(-probs, axis=-1)[:, :cfg.top_k + 1]
        jax.debug.callback(lambda m: seen.append(float(m)),
                           (top[:, :-1] - top[:, 1:]).min())
        return orig(params, x, cfg)
    jmlp.moe_apply = recorded
    try:
        yield seen
    finally:
        jmlp.moe_apply = orig


def margins_hold(seen) -> None:
    jax.effects_barrier()
    assert seen and min(seen) > ROUTING_MARGIN, min(seen, default=None)


def both_models(arch, seed, **kw):
    cfg, jcfg = smoke(arch, **kw)
    model, jmodel = lm.Model(cfg), jlm.build(jcfg)
    arrays = np_params(model.spec(), seed)
    return (cfg, jcfg, model, jmodel,
            lm_params_from_arrays(arrays, cfg=cfg, device="cpu"),
            jax.tree.map(jnp.asarray, arrays))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_and_param_specs_equal_the_reference(arch, mesh):
    cfg, jcfg = smoke(arch)
    model, jmodel = lm.Model(cfg), jlm.build(jcfg)
    assert spec_entries(model.spec(), lambda x: isinstance(x, common.P)) \
        == spec_entries(jmodel.spec(), lambda x: isinstance(x, jcommon.P))
    jm, tm = abstract_meshes(SPEC_MESHES[mesh])
    got = spec_leaves(model.param_specs(tm))
    want = jax.tree.leaves(jmodel.param_shardings(jm))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a == tuple(b.spec)


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_specs_equal_the_reference(arch, mesh):
    """The published configs on the production meshes."""
    jm, tm = abstract_meshes(mesh)
    got = spec_leaves(lm.Model(configs.get_config(arch)).param_specs(tm))
    want = jax.tree.leaves(jlm.build(jconfigs.get_config(arch))
                           .param_shardings(jm))
    assert got == [tuple(b.spec) for b in want]


# ---------------------------------------------------------------------------
# forward, loss, gradients and a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch):
    cfg, jcfg, model, jmodel, params, jparams = both_models(arch, 2)
    jb, tb = np_batch(cfg, 3)
    with reference_margins() as seen:
        want, aux = jmodel.forward(jparams, jb)
    margins_hold(seen)
    got = model.forward(params, tb)
    assert tuple(got.shape) == (B, S, cfg.vocab)
    assert got.dtype == torch.float32 and float(aux) > 0
    assert rel(got, want) <= F32_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_aux_and_grads(arch):
    """The loss adds the auxiliary loss of every layer: it is held
    against the reference's, and against the port's NLL alone plus the
    reference's summed auxiliary loss."""
    cfg, jcfg, model, jmodel, params, jparams = both_models(arch, 4)
    jb, tb = np_batch(cfg, 5)
    with reference_margins() as seen:
        want, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jb)))(jparams)
        _, jaux = jmodel.forward(jparams, jb)
    margins_hold(seen)
    params = common.tree_map(lambda a: a.requires_grad_(), params)
    loss = model.loss(params, tb)
    grads = torch.autograd.grad(loss, common.leaves(params))
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    h, aux = model._trunk(params, tb)
    assert abs(float(aux) - float(jaux)) <= LOSS_RTOL * float(jaux)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        assert rel(g, w) <= GRAD_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_from_a_mid_run_state(arch):
    cfg, jcfg = smoke(arch)
    arrays = np_params(lm.Model(cfg).spec(), 6)
    jb, tb = np_batch(cfg, 7)
    mesh = jax.sharding.AbstractMesh((1, 1), ("data", "model"))
    with reference_margins() as seen:
        jstep = jax.jit(jsteps.build_train_cell(
            jcfg, jconfigs.SMOKE_SHAPE, mesh).step_fn)
        jp = jax.tree.map(jnp.asarray, arrays)
        js = jsteps.make_optimizer(jcfg).init(jp)
        for _ in range(2):
            jp, js, _ = jstep(jp, js, jb)
        js = js._replace(step=jnp.int32(MID_RUN_STEP))
        params = lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                       cfg=cfg, device="cpu")
        state = adamw_state_from_arrays(jax.tree.map(np.asarray, js),
                                        device="cpu")
        want_p, want_s, want_loss = jstep(jp, js, jb)
    margins_hold(seen)
    got_p, got_s, loss = steps.build_cell(cfg, configs.SMOKE_SHAPE).step_fn(
        params, state, tb)
    assert abs(float(loss) - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss))
    assert int(got_s.step) == int(want_s.step) == MID_RUN_STEP + 1
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        g_leaves, w_leaves = common.leaves(got), jax.tree.leaves(want)
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            assert g.dtype == torch.float32
            assert rel(g, w) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_equal_the_reference(arch):
    """Three tokens from one half-filled bf16 cache: each step's logits
    within F32_RTOL of the largest |logit|, the next tokens equal, the
    cache after the steps within one bf16 ulp."""
    cfg, jcfg, model, jmodel, params, jparams = both_models(arch, 8)
    jc = np_cache(tuple(model.decode_state_spec(B, CACHE).k.shape), 9,
                  index=INDEX)
    state = kv_cache_from_arrays(jc, device="cpu")
    jstate = jattention.KVCache(*map(jnp.asarray, jc))
    tokens = np.random.default_rng(10).integers(
        0, cfg.vocab, (B, 3)).astype(np.int32)
    wants = []
    with reference_margins() as seen:
        jstep = jax.jit(jmodel.decode_step)
        for t in range(3):
            want, jstate = jstep(jparams, jstate, jlm.DecodeBatch(
                jnp.asarray(tokens[:, t:t + 1]), jnp.int32(INDEX + t)))
            wants.append(want)
    margins_hold(seen)
    assert len(seen) == 3 * cfg.n_layers
    for t, want in enumerate(wants):
        got, state = model.decode_step(params, state, lm.DecodeBatch(
            torch.from_numpy(tokens[:, t:t + 1]),
            torch.tensor(INDEX + t, dtype=torch.int32)))
        assert got.shape == (B, 1, cfg.vocab)
        assert rel(got, want) <= F32_RTOL
        np.testing.assert_array_equal(
            got[:, -1].argmax(-1).numpy(),
            np.asarray(want, np.float32)[:, -1].argmax(-1))
    for got, want in zip(state, jstate):
        assert within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_at_the_no_drop_capacity(arch):
    """Decode's capacity is set by its batch of one-token sequences, the
    prefill's by the whole batch's tokens, so at the config's 1.25 one
    keeps tokens the other drops; at ``capacity_factor = E / k`` neither
    drops, and the decode logits after t tokens (a float32 cache, one
    token at a time) are ``Model.forward``'s at position t within
    F32_RTOL of the largest |logit|, behind the forward's routing
    margin. At 1.25 the forward drops some of its slots."""
    base = configs.get_smoke(arch)
    cfg = base.replace(capacity_factor=base.n_experts / base.top_k)
    model = lm.Model(cfg)
    params = lm_params_from_arrays(np_params(model.spec(), 11), cfg=cfg,
                                   device="cpu")
    seq = 8
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab, (B, seq)).astype(np.int32))
    full, margin = record_margins(model.forward, params,
                                  lm.Batch(tokens, None))
    assert margin > ROUTING_MARGIN
    state = attention.KVCache(*(t.to(torch.float32) for t in
                                model.init_decode_state(B, seq,
                                                        device="cpu")))
    outs = []
    for t in range(seq):
        logits, state = model.decode_step(params, state, lm.DecodeBatch(
            tokens[:, t:t + 1], torch.tensor(t, dtype=torch.int32)))
        outs.append(logits)
    assert rel(torch.cat(outs, 1), full.numpy()) <= F32_RTOL
    # the config's capacity drops slots of the prefill
    kept = []
    route = mlp.route

    def recorded(logits, c):
        r = route(logits, c)
        kept.append(float(r.keep.to(torch.float32).mean()))
        return r
    mlp.route = recorded
    try:
        lm.Model(base).forward(params, lm.Batch(tokens, None))
    finally:
        mlp.route = route
    assert min(kept) < 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_equals_the_reference(arch):
    """Prompts of 5 tokens, 7 generated, in a cache of 12: every token."""
    cfg, _, model, jmodel, params, jparams = both_models(arch, 13)
    prompts = np.random.default_rng(14).integers(
        0, cfg.vocab, (B, 5)).astype(np.int32)
    with reference_margins() as seen:
        want = jdecode.greedy_decode(jmodel, jparams, jnp.asarray(prompts),
                                     7, max_seq=12)
    margins_hold(seen)
    got = decode.greedy_decode(model, params, torch.from_numpy(prompts), 7,
                               max_seq=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_launcher_decodes_the_moe_family(capsys):
    """``main`` on the CPU for the smoke qwen3-moe: its last line holds
    the tokens ``greedy_decode`` gives on the same seeds."""
    arch = "qwen3-moe-235b-a22b"
    assert decode.main(["--arch", arch, "--smoke", "--batch", "2",
                        "--prompt-len", "3", "--gen", "4",
                        "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])["tokens"]
    cfg = configs.get_smoke(arch)
    model = lm.Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (2, 3), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    assert got == decode.greedy_decode(model, params, prompts, 4,
                                       max_seq=7).tolist()


# ---------------------------------------------------------------------------
# cells, the memory model, the model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    same_meta(abstract_tree(steps.input_specs(configs.get_config(arch),
                                              configs.SHAPES[shape])),
              jsteps.input_specs(jconfigs.get_config(arch),
                                 jconfigs.SHAPES[shape]))


@pytest.mark.parametrize("mesh", [(1, 1), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell_equals_the_reference(arch, mesh):
    """The decode cell's abstract arguments, spec trees (the cache by kv
    heads or along the sequence) and donation."""
    jm, tm = abstract_meshes(mesh)
    sh, jsh = configs.SHAPES["decode_32k"], jconfigs.SHAPES["decode_32k"]
    got = steps.build_cell(configs.get_config(arch), sh, tm)
    want = jsteps.build_cell(jconfigs.get_config(arch), jsh, jm)
    same_meta(abstract_tree(got.abstract_args), want.abstract_args)
    assert got.donate_argnums == want.donate_argnums == (1,)
    for g, w in ((got.in_shardings, want.in_shardings),
                 (got.out_shardings, want.out_shardings)):
        gl = spec_leaves(g)
        wl = jax.tree.leaves(w, is_leaf=lambda x: x is None)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert a == (None if b is None else tuple(b.spec))


@pytest.mark.parametrize("mesh", list(ANALYZE_MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analyze_and_model_flops_equal_the_reference(arch, shape, mesh):
    """Term by term (the MoE buffers' transient among them), on Python
    numbers: equal."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    dims = ANALYZE_MESHES[mesh]
    names = {0: (), 2: ("data", "model"), 3: ("pod", "data", "model")}[
        len(dims)]
    jm = jax.sharding.AbstractMesh(dims, names)
    got = mm.analyze(cfg, configs.SHAPES[shape], dict(zip(names, dims)))
    want = jmm.analyze(jcfg, jconfigs.SHAPES[shape], jm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_gb == want.total_gb
    n = common.spec_param_count(lm.Model(cfg).spec())
    assert n == jcommon.spec_param_count(jlm.build(jcfg).spec())
    assert roofline.active_params(cfg, n) == jroofline.active_params(jcfg, n)
    assert roofline.active_params(cfg, n) < n
    assert roofline.model_flops(cfg, configs.SHAPES[shape], n) == \
        jroofline.model_flops(jcfg, jconfigs.SHAPES[shape], n)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_flops_are_the_hand_count(arch, kind):
    """The smoke cells on meta tensors, remat "none" and "full": the
    router over every token and the experts at the batch's capacity
    (``tests/test_torch_dryrun.py``'s ``moe_flops``)."""
    for remat in ("none", "full"):
        cfg = configs.get_smoke(arch).replace(remat=remat)
        sh = dataclasses.replace(configs.SMOKE_SHAPE, kind=kind)
        cell = steps.build_cell(cfg, sh)
        with FlopCounterMode(display=False) as fc:
            cell.step_fn(*cell.abstract_args)
        assert fc.get_total_flops() == moe_flops(cfg, sh)
