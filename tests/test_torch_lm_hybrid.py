"""PyTorch port, the hybrid family of the LM zoo: ``zamba2-1.2b`` (Mamba-2
layers in groups of ``shared_attn_every``, each full group followed by
one shared attention + MLP block fed ``x + h0 @ emb_proj``) through
``repro_torch.models``, ``repro_torch.launch.steps`` and
``launch.decode``, against ``repro.models.lm``, ``repro.launch.steps``
and ``repro.launch.decode`` on the same numpy inputs (the mirror of
``tests/test_torch_lm_moe.py`` for the hybrid).

The smoke config (4 layers, two shared-block calls): ``spec`` and
``param_specs`` against the reference's ``spec`` and ``param_shardings``
on (1, 1), (8, 1), (4, 2) and 16x16 meshes, the full config's on the
production meshes; ``Model.forward``'s logits within ``F32_RTOL`` of the
largest |logit|, and in bf16 under remat "full" within ``BF16_RTOL``;
``Model.loss`` within ``LOSS_RTOL`` relative and each gradient leaf
within ``GRAD_RTOL`` of its largest |entry|, and in bf16 under remat
"full" (``steps.loss_and_grads`` against the reference's
``value_and_grad`` of the cast tree) within ``BF16_RTOL``; one train step
from a mid-run AdamW state within ``GRAD_RTOL``; ``Model.decode_step``
over three tokens from a half-filled state (float32 SSM states, bf16
convolution buffers and caches, ``convert.hybrid_state_from_arrays``):
the logits within ``F32_RTOL``, the next tokens equal, the SSM states
within ``F32_RTOL`` and the buffers and caches within one bf16 ulp;
decode against the port's own forward with float32 states within
``DECODE_RTOL`` (the reference's bf16 states round even the current
token's ``xBC``; they are recorded beside it, not held);
``greedy_decode`` token for token and the launcher's ``main``; the
decode step refused without a shared block, as the reference's fails;
the full config's ``input_specs`` for its four shapes and the decode
cell's spec trees against the reference's, ``model_flops`` and
``active_params``; the smoke cells' FLOPs on meta tensors against the
hand count (``tests/test_torch_dryrun.py``'s ``hybrid_flops``).

The weights are drawn at ``WEIGHT_STD`` = 0.02 (norm scales ``1 + 0.1
N``), where the random model is well conditioned: at the 0.2 of the
other families' tests the reference's own float32 logits move by 1.3e-5
of the largest |logit| for a 1e-7 relative change of its weights, and
its bf16 ones by 4.8%.
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
from test_torch_dryrun import hybrid_flops
from test_torch_lm_dense import abstract_meshes, np_batch, np_params, rel
from repro import configs as jconfigs
from repro.distributed import roofline as jroofline
from repro.launch import decode as jdecode
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.convert import (adamw_state_from_arrays,
                                 hybrid_state_from_arrays,
                                 lm_params_from_arrays)
from repro_torch.distributed import roofline
from repro_torch.launch import decode, steps
from repro_torch.models import common, lm, ssm

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ARCH = "zamba2-1.2b"
F32_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_RTOL = 5e-2
DECODE_RTOL = 1e-4
WEIGHT_STD = 0.02
MID_RUN_STEP = 2400
B, S = 2, 32
#: the decode state: its cache's length and valid positions
CACHE, INDEX = 32, 13
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


def np_state(model, seed, b=B, cache=CACHE, index=INDEX):
    """A half-filled hybrid state as numpy: float32 N(0, 1) SSM states,
    bf16-valued N(0, 1) convolution buffers, bf16 caches zero from
    ``index`` on."""
    rng = np.random.default_rng(seed)
    spec = model.decode_state_spec(b, cache)

    def bf16(x):
        return torch.from_numpy(x).to(torch.bfloat16).to(
            torch.float32).numpy()

    def normal(t):
        return rng.standard_normal(tuple(t.shape)).astype(np.float32)

    def kv(t):
        x = normal(t)
        x[:, :, index:] = 0
        return bf16(x)
    return {"mamba": jssm.SSMState(normal(spec["mamba"].ssm),
                                   bf16(normal(spec["mamba"].conv))),
            "attn": jattention.KVCache(*map(kv, spec["attn"]))}


def j_state(arrays):
    return {"mamba": jssm.SSMState(
                jnp.asarray(arrays["mamba"].ssm),
                jnp.asarray(arrays["mamba"].conv, jnp.bfloat16)),
            "attn": jattention.KVCache(*(jnp.asarray(a, jnp.bfloat16)
                                         for a in arrays["attn"]))}


# ---------------------------------------------------------------------------
# the family, specs
# ---------------------------------------------------------------------------

def test_the_model_takes_the_hybrid():
    assert "hybrid" in lm.PORTED_FAMILIES and "hybrid" in lm.DECODE_FAMILIES
    assert lm.UNPORTED_FAMILIES == {"ssm": "4(e)"}
    assert configs.ARCH_IDS[0] == ARCH == jconfigs.ARCH_IDS[0]
    model = lm.Model(configs.get_config(ARCH))
    assert common.spec_param_count(model.spec()) == 1_174_590_336
    assert lm._hybrid_positions(model.cfg) == [5, 11, 17, 23, 29, 35]


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
    """The published config on the production meshes: in_proj's 8384
    columns and the 4224 convolution channels split 16 ways, as its 64
    SSM heads; ``emb_proj``'s first "embed" dim over the data dims."""
    jm, tm = abstract_meshes(mesh)
    specs = lm.Model(configs.get_config(ARCH)).param_specs(tm)
    want = jax.tree.leaves(jlm.build(jconfigs.get_config(ARCH))
                           .param_shardings(jm))
    assert spec_leaves(specs) == [tuple(b.spec) for b in want]
    embed = "data" if len(mesh) == 2 else ("pod", "data")
    assert specs["layers"]["in_proj"] == (None, embed, "model")
    assert specs["shared_attn"]["emb_proj"] == (embed, None)


# ---------------------------------------------------------------------------
# forward, loss, gradients and a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward(dtype):
    kw = {} if dtype == "float32" else {"compute_dtype": dtype,
                                         "remat": "full"}
    cfg, jcfg, model, jmodel, params, jparams = both_models(2, **kw)
    jb, tb = np_batch(cfg, 3, B, S)
    want, _ = jax.jit(jmodel.forward)(jparams, jb)
    got = model.forward(params, tb)
    assert tuple(got.shape) == (B, S, cfg.vocab)
    assert got.dtype == lm.dtype_of(dtype)
    assert rel(got, want) <= (F32_RTOL if dtype == "float32" else BF16_RTOL)


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
        assert rel(g, w) <= GRAD_RTOL


def test_bf16_remat_loss_and_grads():
    """bf16 under remat "full": ``steps.loss_and_grads`` (the gradients
    of the cast tree, every Mamba layer and shared-block call
    recomputed) against the reference's on the same cast tree."""
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
    """Three tokens from one half-filled state: each step's logits within
    F32_RTOL, the next tokens equal; then the SSM states within F32_RTOL,
    the convolution buffers and caches within one bf16 ulp."""
    cfg, jcfg, model, jmodel, params, jparams = both_models(8)
    arrays = np_state(model, 9)
    state = hybrid_state_from_arrays(arrays, device="cpu")
    jstate = j_state(arrays)
    tokens = np.random.default_rng(10).integers(
        0, cfg.vocab, (B, 3)).astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(3):
        want, jstate = jstep(jparams, jstate, jlm.DecodeBatch(
            jnp.asarray(tokens[:, t:t + 1]), jnp.int32(INDEX + t)))
        got, state = model.decode_step(params, state, lm.DecodeBatch(
            torch.from_numpy(tokens[:, t:t + 1]),
            torch.tensor(INDEX + t, dtype=torch.int32)))
        assert got.shape == (B, 1, cfg.vocab)
        assert rel(got, want) <= F32_RTOL
        np.testing.assert_array_equal(
            got[:, -1].argmax(-1).numpy(),
            np.asarray(want, np.float32)[:, -1].argmax(-1))
    assert rel(state["mamba"].ssm, jstate["mamba"].ssm) <= F32_RTOL
    for got, want in ((state["mamba"].conv, jstate["mamba"].conv),
                      *zip(state["attn"], jstate["attn"])):
        assert got.dtype == torch.bfloat16
        assert within_one_bf16_ulp(got, np.asarray(want, np.float32))


def primed(model, params, tokens, dtype):
    """``tokens`` fed one at a time into a zero state whose buffers and
    caches are ``dtype`` (the SSM states float32): the decode logits."""
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
    """Eight tokens one at a time, float32 buffers and caches, against
    ``Model.forward``: within DECODE_RTOL of the largest |logit|. With
    the model's bf16 ones (which round even the current token's ``xBC``
    before the convolution, as the reference's) the difference is
    larger, and not held."""
    cfg = configs.get_smoke(ARCH)
    model = lm.Model(cfg)
    params = lm_params_from_arrays(np_params(model.spec(), 11, WEIGHT_STD),
                                   cfg=cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab, (B, 8)).astype(np.int32))
    full = model.forward(params, lm.Batch(tokens, None))
    assert rel(primed(model, params, tokens, torch.float32),
               full.numpy()) <= DECODE_RTOL
    bf16 = rel(primed(model, params, tokens, torch.bfloat16), full.numpy())
    assert DECODE_RTOL < bf16 < BF16_RTOL


def test_greedy_decode_equals_the_reference():
    """Prompts of 5 tokens, 7 generated, in a state of 12: every token."""
    cfg, _, model, jmodel, params, jparams = both_models(13)
    prompts = np.random.default_rng(14).integers(
        0, cfg.vocab, (B, 5)).astype(np.int32)
    want = jdecode.greedy_decode(jmodel, jparams, jnp.asarray(prompts), 7,
                                 max_seq=12)
    got = decode.greedy_decode(model, params, torch.from_numpy(prompts), 7,
                               max_seq=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_launcher_decodes_the_hybrid(capsys):
    """``main`` on the CPU for the smoke zamba2: its last line holds the
    tokens ``greedy_decode`` gives on the same seeds."""
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


def test_decode_without_a_shared_block_is_refused():
    """``shared_attn_every = 0``: the forward runs the Mamba stack alone;
    the decode step raises, where the reference's fails stacking no
    cache."""
    cfg, jcfg = smoke(shared_attn_every=0)
    model = lm.Model(cfg)
    params = lm_params_from_arrays(np_params(model.spec(), 15, WEIGHT_STD),
                                   cfg=cfg, device="cpu")
    tokens = torch.zeros((B, 16), dtype=torch.int32)
    assert model.forward(params, lm.Batch(tokens, None)).shape == (
        B, 16, cfg.vocab)
    state = model.init_decode_state(B, 16, device="cpu")
    assert state["attn"].k.shape[0] == 0
    with pytest.raises(ValueError, match="shared block"):
        model.decode_step(params, state, lm.DecodeBatch(
            tokens[:, :1], torch.tensor(0, dtype=torch.int32)))
    jmodel = jlm.build(jcfg)
    with pytest.raises(ValueError, match="stack"):
        jax.eval_shape(jmodel.decode_step, jmodel.abstract_params(),
                       jmodel.decode_state_spec(B, 16),
                       jlm.DecodeBatch(jnp.zeros((B, 1), jnp.int32),
                                       jnp.int32(0)))


def test_hybrid_state_from_arrays():
    """The reference's state passes exactly, on the device asked for: the
    SSM states float32 (a copy: the step writes in place), the buffers
    and caches bf16; float32 buffer and cache values are rounded."""
    model = lm.Model(configs.get_smoke(ARCH))
    arrays = np_state(model, 16, b=2, cache=6, index=3)
    got = hybrid_state_from_arrays(arrays, device="cpu")
    assert isinstance(got["mamba"], ssm.SSMState)
    assert got["mamba"].ssm.dtype == torch.float32
    np.testing.assert_array_equal(got["mamba"].ssm.numpy(),
                                  arrays["mamba"].ssm)
    got["mamba"].ssm.zero_()
    assert arrays["mamba"].ssm.any()
    for g, w in ((got["mamba"].conv, arrays["mamba"].conv),
                 *zip(got["attn"], arrays["attn"])):
        assert g.dtype == torch.bfloat16 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.to(torch.float32).numpy(), w)
    x = np.float32(1 + 2 ** -12)
    one = hybrid_state_from_arrays(
        {"mamba": jssm.SSMState(np.full((1,), x), np.full((1,), x)),
         "attn": jattention.KVCache(np.full((1,), x), np.full((1,), x))},
        device="cpu")
    assert float(one["mamba"].ssm[0]) == x
    assert float(one["mamba"].conv[0]) == float(one["attn"].k[0]) == 1.0


# ---------------------------------------------------------------------------
# cells, the model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_input_specs_equal_the_reference(shape):
    """The four shapes' abstract arguments; the decode states a dict of
    the stacked SSM states and caches, as the reference's."""
    same_meta(abstract_tree(steps.input_specs(configs.get_config(ARCH),
                                              configs.SHAPES[shape])),
              jsteps.input_specs(jconfigs.get_config(ARCH),
                                 jconfigs.SHAPES[shape]))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", [(1, 1), (16, 16), (2, 16, 16)])
def test_decode_cell_equals_the_reference(mesh, shape):
    """The decode cell's abstract arguments, spec trees (the SSM states
    by heads, the buffers whole on "model", the caches by kv heads) and
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
    Mamba layers' products (the SSD's over four chunks) and the two
    shared-block calls', the unembedding; the train step's backward and
    recompute."""
    for remat in ("none", "full"):
        cfg = configs.get_smoke(ARCH).replace(remat=remat)
        sh = dataclasses.replace(configs.SMOKE_SHAPE, kind=kind)
        cell = steps.build_cell(cfg, sh)
        with FlopCounterMode(display=False) as fc:
            cell.step_fn(*cell.abstract_args)
        assert fc.get_total_flops() == hybrid_flops(cfg, sh)
