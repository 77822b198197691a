"""PyTorch port, the xLSTM family of the LM zoo: ``xlstm-350m`` (mLSTM
blocks with an sLSTM block every ``slstm_every``) through
``repro_torch.models``, ``repro_torch.launch.steps`` and
``launch.decode``, against ``repro.models.lm``, ``repro.launch.steps``
and ``repro.launch.decode`` on the same numpy inputs (the mirror of
``tests/test_torch_lm_hybrid.py`` for the xLSTM).

The smoke config (3 blocks: two mLSTM, one sLSTM): ``spec`` and
``param_specs`` against the reference's ``spec`` and ``param_shardings``
on (1, 1), (8, 1), (4, 2) and 16x16 meshes, the full config's on the
production meshes, its parameter count (518,926,504); ``Model.forward``'s
logits within ``F32_RTOL`` of the largest |logit| (over one, two and
four chunks), and in bf16 under remat "full" within ``BF16_RTOL``;
``Model.loss`` within ``LOSS_RTOL`` relative and each gradient leaf
within ``GRAD_RTOL`` of its largest |entry|, and in bf16 under remat
"full" (``steps.loss_and_grads`` against the reference's
``value_and_grad`` of the cast tree) within ``BF16_RTOL``; one train step
from a mid-run AdamW state within ``GRAD_RTOL``; ``Model.decode_step``
over three tokens from a reached state (float32 C, n, m and sLSTM
leaves, bf16 convolution buffers, ``convert.xlstm_state_from_arrays``):
the logits within ``F32_RTOL``, the next tokens equal, the float32
states within ``F32_RTOL`` and the buffers within one bf16 ulp; decode
against the port's own forward with float32 buffers within
``DECODE_RTOL`` (the reference's bf16 buffers round the current token's
``x_m`` before the convolution: within ``BF16_RTOL``, not held to
``DECODE_RTOL``);
``greedy_decode`` token for token and the launcher's ``main``; the full
config's ``decode_state_spec`` and ``input_specs`` for its four shapes
and the decode cell's spec trees against the reference's,
``model_flops`` and ``active_params``; the smoke cells' FLOPs on meta
tensors against the hand count (``tests/test_torch_dryrun.py``'s
``xlstm_flops``).

The weights are drawn at ``WEIGHT_STD`` = 0.02 (norm scales and ``b_f``
``1 + 0.1 N``, the ``zeros`` leaves ``0.1 N``), where the random model is
well conditioned in bf16: at the 0.2 of the dense families' tests the
reference's own bf16 gradients lie up to 40% of a leaf's largest |entry|
off its float32 ones (the sLSTM's bias), at 0.02 within 1.4%.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_parity import within_one_bf16_ulp
from test_torch_cells import abstract_tree, same_meta, spec_leaves
from test_torch_dryrun import xlstm_flops
from test_torch_lm_dense import abstract_meshes, np_batch, np_params, rel
from repro import configs as jconfigs
from repro.distributed import roofline as jroofline
from repro.launch import decode as jdecode
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import xlstm as jx
from repro_torch import configs
from repro_torch.convert import (adamw_state_from_arrays,
                                 lm_params_from_arrays,
                                 xlstm_state_from_arrays)
from repro_torch.distributed import roofline
from repro_torch.launch import decode, steps
from repro_torch.models import common, lm, xlstm

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ARCH = "xlstm-350m"
F32_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_RTOL = 5e-2
DECODE_RTOL = 1e-4
WEIGHT_STD = 0.02
MID_RUN_STEP = 2400
B, S = 2, 32
SPEC_MESHES = {"1x1": (1, 1), "8x1": (8, 1), "4x2": (4, 2),
               "16x16": (16, 16)}
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def smoke(**kw):
    return (configs.get_smoke(ARCH).replace(**kw),
            jconfigs.get_smoke(ARCH).replace(**kw))


def both_models(seed, **kw):
    cfg, jcfg = smoke(**kw)
    model, jmodel = lm.Model(cfg), jlm.build(jcfg)
    arrays = np_params(model.spec(), seed, WEIGHT_STD)
    return (cfg, jcfg, model, jmodel,
            lm_params_from_arrays(arrays, cfg=cfg, device="cpu"),
            jax.tree.map(jnp.asarray, arrays))


def spec_entries(spec, is_p):
    out = []

    def walk(node, path):
        if is_p(node):
            out.append((path, tuple(node.shape), tuple(node.axes),
                        node.init, node.scale))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
    walk(spec, "")
    return out


def reached_state(model, params, seed, b=B, steps_=6):
    """A state the recurrence can reach: ``steps_`` random tokens decoded
    from zeros by the port (float32 convolution buffers, rounded to bf16
    after), as numpy: each block's ``MLSTMState`` or ``SLSTMState``."""
    cfg = model.cfg
    st = lm.map_state(lambda t: t.to(torch.float32),
                      model.init_decode_state(b, 1, device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, steps_)).astype(np.int32))
    for t in range(steps_):
        model.decode_step(params, st, lm.DecodeBatch(
            tokens[:, t:t + 1], torch.tensor(t, dtype=torch.int32)))

    def arrays(s):
        leaves = [t.numpy().copy() for t in s]
        if isinstance(s, xlstm.MLSTMState):
            leaves[3] = torch.from_numpy(leaves[3]).to(torch.bfloat16).to(
                torch.float32).numpy()
        return type(s)(*leaves)
    return [arrays(s) for s in st]


def j_state(arrays):
    return [jx.MLSTMState(*map(jnp.asarray, s[:3]),
                          jnp.asarray(s.conv, jnp.bfloat16))
            if isinstance(s, xlstm.MLSTMState)
            else jx.SLSTMState(*map(jnp.asarray, s)) for s in arrays]


# ---------------------------------------------------------------------------
# the family, specs
# ---------------------------------------------------------------------------

def test_the_model_takes_the_xlstm():
    assert "ssm" in lm.PORTED_FAMILIES and "ssm" in lm.DECODE_FAMILIES
    assert ARCH in configs.ARCH_IDS
    model = lm.Model(configs.get_config(ARCH))
    assert common.spec_param_count(model.spec()) == 518_926_504
    kinds = lm._xlstm_kinds(model.cfg)
    assert [i for i, k in enumerate(kinds) if k == "slstm"] == [7, 15, 23]
    assert lm._xlstm_segments(model.cfg) == [
        ("m", 0, 7), ("s", 0), ("m", 7, 14), ("s", 1), ("m", 14, 21),
        ("s", 2)]
    jcfg = jconfigs.get_config(ARCH)
    assert lm._xlstm_segments(model.cfg) == jlm._xlstm_segments(jcfg)
    assert lm._xlstm_kinds(model.cfg) == jlm._xlstm_kinds(jcfg)


@pytest.mark.parametrize("every", [0, 1, 2])
def test_segments_equal_the_reference(every):
    cfg, jcfg = smoke(n_layers=5, slstm_every=every)
    assert lm._xlstm_segments(cfg) == jlm._xlstm_segments(jcfg)
    assert lm._xlstm_kinds(cfg) == jlm._xlstm_kinds(jcfg)


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
def test_spec_and_param_specs_equal_the_reference(mesh):
    cfg, jcfg = smoke()
    model, jmodel = lm.Model(cfg), jlm.build(jcfg)
    assert spec_entries(model.spec(), lambda x: isinstance(x, common.P)) \
        == spec_entries(jmodel.spec(), lambda x: isinstance(x, jcommon.P))
    jm, tm = abstract_meshes(SPEC_MESHES[mesh])
    got = spec_leaves(model.param_specs(tm))
    want = jax.tree.leaves(jmodel.param_shardings(jm))
    assert got == [tuple(b.spec) for b in want]


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)])
def test_full_param_specs_equal_the_reference(mesh):
    jm, tm = abstract_meshes(mesh)
    specs = lm.Model(configs.get_config(ARCH)).param_specs(tm)
    want = jax.tree.leaves(jlm.build(jconfigs.get_config(ARCH))
                           .param_shardings(jm))
    assert spec_leaves(specs) == [tuple(b.spec) for b in want]


# ---------------------------------------------------------------------------
# forward, loss, gradients and a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [16, 32, 64])
def test_forward(s):
    """One, two and four mLSTM chunks of 16."""
    cfg, jcfg, model, jmodel, params, jparams = both_models(2)
    jb, tb = np_batch(cfg, 3, B, s)
    want, _ = jax.jit(jmodel.forward)(jparams, jb)
    got = model.forward(params, tb)
    assert tuple(got.shape) == (B, s, cfg.vocab)
    assert got.dtype == torch.float32
    assert rel(got, want) <= F32_RTOL


def test_bf16_remat_forward():
    cfg, jcfg, model, jmodel, params, jparams = both_models(
        16, compute_dtype="bfloat16", remat="full")
    jb, tb = np_batch(cfg, 17, B, S)
    want, _ = jax.jit(jmodel.forward)(jparams, jb)
    got = model.forward(params, tb)
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= BF16_RTOL


def test_loss_and_grads():
    cfg, jcfg, model, jmodel, params, jparams = both_models(4)
    jb, tb = np_batch(cfg, 5, B, S)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb)))(jparams)
    params = common.tree_map(lambda a: a.requires_grad_(), params)
    loss = model.loss(params, tb)
    grads = torch.autograd.grad(loss, common.leaves(params))
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= LOSS_RTOL * abs(float(want))
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        assert bool(torch.isfinite(g).all())
        assert rel(g, w) <= GRAD_RTOL


def test_bf16_remat_loss_and_grads():
    """bf16 under remat "full": ``steps.loss_and_grads`` (the gradients
    of the cast tree, every block recomputed, the sLSTM scan's backward
    pass inside the recompute) against the reference's on the same cast
    tree."""
    cfg, jcfg, model, jmodel, params, jparams = both_models(
        14, compute_dtype="bfloat16", remat="full")
    jb, tb = np_batch(cfg, 15, B, S)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, jb)))(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams))
    loss, grads = steps.loss_and_grads(model, params, tb)
    assert abs(float(loss) - float(want)) <= BF16_RTOL * abs(float(want))
    for g, w in zip(common.leaves(grads), jax.tree.leaves(jgrads),
                    strict=True):
        assert g.dtype == torch.bfloat16
        assert rel(g, w) <= BF16_RTOL


def test_remat_full_is_bitwise_none():
    """float32: remat "full" (each block a checkpoint, the sLSTM op's
    backward pass under it) gives the bits of "none"."""
    cfg, _, model, _, params, _ = both_models(18)
    _, tb = np_batch(cfg, 19, B, S)
    full = lm.Model(cfg.replace(remat="full"))
    a = steps.loss_and_grads(model, params, tb)
    b = steps.loss_and_grads(full, params, tb)
    for x, y in zip(common.leaves(list(a)), common.leaves(list(b)),
                    strict=True):
        assert torch.equal(x, y)


def test_train_step_from_a_mid_run_state():
    cfg, jcfg = smoke()
    arrays = np_params(lm.Model(cfg).spec(), 6, WEIGHT_STD)
    jb, tb = np_batch(cfg, 7, B, S)
    mesh = jax.sharding.AbstractMesh((1, 1), ("data", "model"))
    jstep = jax.jit(jsteps.build_train_cell(
        jcfg, jconfigs.SMOKE_SHAPE, mesh).step_fn)
    jp = jax.tree.map(jnp.asarray, arrays)
    js = jsteps.make_optimizer(jcfg).init(jp)
    for _ in range(2):
        jp, js, _ = jstep(jp, js, jb)
    js = js._replace(step=jnp.int32(MID_RUN_STEP))
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jp), cfg=cfg,
                                   device="cpu")
    state = adamw_state_from_arrays(jax.tree.map(np.asarray, js),
                                    device="cpu")
    want_p, want_s, want_loss = jstep(jp, js, jb)
    got_p, got_s, loss = steps.build_cell(cfg, configs.SMOKE_SHAPE).step_fn(
        params, state, tb)
    assert abs(float(loss) - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss))
    assert int(got_s.step) == int(want_s.step) == MID_RUN_STEP + 1
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        for g, w in zip(common.leaves(got), jax.tree.leaves(want),
                        strict=True):
            assert g.dtype == torch.float32
            assert rel(g, w) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_decode_steps_equal_the_reference():
    """Three tokens from one reached state: each step's logits within
    F32_RTOL, the next tokens equal; then the float32 states within
    F32_RTOL and the bf16 convolution buffers within one bf16 ulp."""
    cfg, jcfg, model, jmodel, params, jparams = both_models(8)
    arrays = reached_state(model, params, 9)
    state = xlstm_state_from_arrays(arrays, device="cpu")
    jstate = j_state(arrays)
    tokens = np.random.default_rng(10).integers(
        0, cfg.vocab, (B, 3)).astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(3):
        want, jstate = jstep(jparams, jstate, jlm.DecodeBatch(
            jnp.asarray(tokens[:, t:t + 1]), jnp.int32(6 + t)))
        got, state = model.decode_step(params, state, lm.DecodeBatch(
            torch.from_numpy(tokens[:, t:t + 1]),
            torch.tensor(6 + t, dtype=torch.int32)))
        assert got.shape == (B, 1, cfg.vocab)
        assert rel(got, want) <= F32_RTOL
        np.testing.assert_array_equal(
            got[:, -1].argmax(-1).numpy(),
            np.asarray(want, np.float32)[:, -1].argmax(-1))
    for got, want in zip(state, jstate, strict=True):
        assert type(got).__name__ == type(want).__name__
        for name, g, w in zip(got._fields, got, want):
            if name == "conv":
                assert g.dtype == torch.bfloat16
                assert within_one_bf16_ulp(g, np.asarray(w, np.float32))
            else:
                assert g.dtype == torch.float32
                assert rel(g, w) <= F32_RTOL


def primed(model, params, tokens, dtype):
    """``tokens`` fed one at a time into a zero state whose convolution
    buffers are ``dtype``: the decode logits."""
    st = lm.map_state(lambda t: t.to(dtype) if t.dtype == torch.bfloat16
                      else t, model.init_decode_state(
                          tokens.shape[0], tokens.shape[1], device="cpu"))
    outs = []
    for t in range(tokens.shape[1]):
        logits, st = model.decode_step(params, st, lm.DecodeBatch(
            tokens[:, t:t + 1], torch.tensor(t, dtype=torch.int32)))
        outs.append(logits)
    return torch.cat(outs, 1)


def test_decode_matches_forward():
    """32 tokens (two mLSTM chunks) one at a time, float32 buffers,
    against ``Model.forward``: within DECODE_RTOL of the largest |logit|.
    With the model's bf16 buffers (which round the current token's
    ``x_m`` before the convolution, as the reference's) the logits move,
    within BF16_RTOL (1.1e-6 of the largest |logit| at these weights);
    that gap is not held to DECODE_RTOL."""
    cfg = configs.get_smoke(ARCH)
    model = lm.Model(cfg)
    params = lm_params_from_arrays(np_params(model.spec(), 11, WEIGHT_STD),
                                   cfg=cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab, (B, 32)).astype(np.int32))
    full = model.forward(params, lm.Batch(tokens, None))
    assert rel(primed(model, params, tokens, torch.float32),
               full.numpy()) <= DECODE_RTOL
    bf16 = rel(primed(model, params, tokens, torch.bfloat16), full.numpy())
    assert 0 < bf16 < BF16_RTOL


def test_greedy_decode_equals_the_reference():
    """Prompts of 5 tokens, 7 generated: every token."""
    cfg, _, model, jmodel, params, jparams = both_models(13)
    prompts = np.random.default_rng(14).integers(
        0, cfg.vocab, (B, 5)).astype(np.int32)
    want = jdecode.greedy_decode(jmodel, jparams, jnp.asarray(prompts), 7,
                                 max_seq=12)
    got = decode.greedy_decode(model, params, torch.from_numpy(prompts), 7,
                               max_seq=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_launcher_decodes_the_xlstm(capsys):
    """``main`` on the CPU for the smoke xlstm-350m: its last line holds
    the tokens ``greedy_decode`` gives on the same seeds."""
    assert decode.main(["--arch", ARCH, "--smoke", "--batch", "2",
                        "--prompt-len", "3", "--gen", "4",
                        "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])["tokens"]
    cfg = configs.get_smoke(ARCH)
    model = lm.Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (2, 3), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    assert got == decode.greedy_decode(model, params, prompts, 4,
                                       max_seq=7).tolist()


def test_xlstm_state_from_arrays():
    """The reference's state passes exactly, on the device asked for:
    C, n, m and the sLSTM leaves float32 copies (the step writes in
    place), the buffers bf16 (a float32 value rounded) or the dtype
    asked for."""
    model = lm.Model(configs.get_smoke(ARCH))
    rng = np.random.default_rng(16)
    arrays = [type(t)(*(rng.standard_normal(tuple(x.shape)).astype(
        np.float32) for x in t)) for t in model.decode_state_spec(2, 4)]
    got = xlstm_state_from_arrays(arrays, device="cpu")
    assert [type(g) for g in got] == [xlstm.MLSTMState, xlstm.MLSTMState,
                                      xlstm.SLSTMState]
    for g, a in zip(got, arrays):
        for name, x, y in zip(g._fields, g, a):
            assert x.device.type == "cpu"
            if name == "conv":
                assert x.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    x.to(torch.float32).numpy(),
                    torch.from_numpy(y).to(torch.bfloat16).to(
                        torch.float32).numpy())
            else:
                assert x.dtype == torch.float32
                np.testing.assert_array_equal(x.numpy(), y)
    got[0].C.zero_()
    assert arrays[0].C.any()
    f32 = xlstm_state_from_arrays(arrays, conv_dtype=torch.float32,
                                  device="cpu")
    np.testing.assert_array_equal(f32[1].conv.numpy(), arrays[1].conv)


# ---------------------------------------------------------------------------
# cells, the model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3])
def test_decode_state_spec_equals_the_reference(batch):
    """A list of each block's state, whatever the sequence."""
    got = lm.Model(configs.get_config(ARCH)).decode_state_spec(batch, 7)
    want = jlm.build(jconfigs.get_config(ARCH)).decode_state_spec(batch, 7)
    assert isinstance(got, list) and len(got) == len(want) == 24
    same_meta(abstract_tree(got), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_input_specs_equal_the_reference(shape):
    same_meta(abstract_tree(steps.input_specs(configs.get_config(ARCH),
                                              configs.SHAPES[shape])),
              jsteps.input_specs(jconfigs.get_config(ARCH),
                                 jconfigs.SHAPES[shape]))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (16, 16), (2, 16, 16)])
def test_decode_cell_equals_the_reference(mesh, shape):
    """The decode cell's abstract arguments, spec trees (each block's
    state by heads where "model" divides them, the buffers whole) and
    donation."""
    jm, tm = abstract_meshes(mesh)
    got = steps.build_cell(configs.get_config(ARCH), configs.SHAPES[shape],
                           tm)
    want = jsteps.build_cell(jconfigs.get_config(ARCH),
                             jconfigs.SHAPES[shape], jm)
    same_meta(abstract_tree(got.abstract_args), want.abstract_args)
    assert got.donate_argnums == want.donate_argnums == (1,)
    for g, w in ((got.in_shardings, want.in_shardings),
                 (got.out_shardings, want.out_shardings)):
        wl = jax.tree.leaves(w, is_leaf=lambda x: x is None)
        assert spec_leaves(g) == [None if b is None else tuple(b.spec)
                                  for b in wl]


@pytest.mark.parametrize("shape", SHAPES)
def test_model_flops_equal_the_reference(shape):
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    n = common.spec_param_count(lm.Model(cfg).spec())
    assert n == jcommon.spec_param_count(jlm.build(jcfg).spec())
    assert roofline.active_params(cfg, n) == jroofline.active_params(jcfg, n)
    assert roofline.model_flops(cfg, configs.SHAPES[shape], n) == \
        jroofline.model_flops(jcfg, jconfigs.SHAPES[shape], n)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_flops_are_the_hand_count(kind):
    """The smoke cells on meta tensors, remat "none" and "full": the
    mLSTM blocks' products (the chunkwise form's over four chunks), the
    sLSTM block's (the scan's registered counts), the unembedding; the
    train step's backward and recompute."""
    for remat in ("none", "full"):
        cfg = configs.get_smoke(ARCH).replace(remat=remat)
        sh = dataclasses.replace(configs.SMOKE_SHAPE, kind=kind)
        cell = steps.build_cell(cfg, sh)
        with FlopCounterMode(display=False) as fc:
            cell.step_fn(*cell.abstract_args)
        assert fc.get_total_flops() == xlstm_flops(cfg, sh)
