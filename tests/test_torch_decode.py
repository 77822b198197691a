"""PyTorch port, the decode path of the dense and vlm families, unsharded,
on the CPU: ``attention.decode_step``, ``Model.decode_step``,
``launch/decode.greedy_decode`` and the decode cell of ``launch/steps``
against ``repro.models`` and ``repro.launch`` on the same numpy inputs.

For the smoke configs of the five decoders (``olmo-1b``,
``codeqwen1.5-7b``, ``internlm2-1.8b``, ``deepseek-67b``,
``internvl2-76b``), from one half-filled bf16 cache carried across by
``convert.kv_cache_from_arrays``: the attention's decode step and the
model's, their outputs within ``F32_RTOL`` of the largest |entry| in
float32 (``BF16_NET_RTOL`` in bf16), the new cache entries within one
bf16 ulp in float32 (k and v are float32 sums rounded to bf16, so a sum
on either side of a rounding boundary moves one ulp), the next tokens
equal; the
decode logits against the port's own ``Model.forward`` on the same
tokens at the reference's own 2e-2 (``tests/test_arch_smoke.py``);
``greedy_decode`` against the reference's, token for token. Also
``analyze()`` at ``decode_32k`` against the reference's term by term
(one device, 16x16, 2x16x16, and the cache along the sequence under a
rules override), ``input_specs`` and ``build_cell`` against the
reference's (meta shapes, dtypes, spec trees, donation), the decode
cell's FLOPs on meta tensors against the hand count, the encoder's
``ValueError`` and the other families' ROADMAP items, and the step's
source free of host syncs (the card's run is held by ``chip_smoke.py``
under ``torch.cuda.set_sync_debug_mode("error")``).

The weights are drawn at ``WEIGHT_STD`` (norm scales ``1 + 0.1 N``), as
in ``tests/test_torch_lm_dense.py``.
"""

import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_parity import within_one_bf16_ulp
from test_torch_cells import abstract_tree, same_meta, spec_leaves
from repro import configs as jconfigs
from repro.distributed import memory_model as jmm
from repro.launch import decode as jdecode
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import kv_cache_from_arrays, lm_params_from_arrays
from repro_torch.distributed import memory_model as mm
from repro_torch.launch import decode, steps
from repro_torch.models import attention, common, lm

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ARCHS = ["olmo-1b", "codeqwen1.5-7b", "internlm2-1.8b", "deepseek-67b",
         "internvl2-76b"]
WEIGHT_STD = 0.2
F32_RTOL = 1e-5
BF16_NET_RTOL = 5e-2
#: the reference's decode-against-forward tolerance
FORWARD_TOL = 2e-2
#: batch, the cache's length and its valid positions
B, S, INDEX = 2, 32, 13
ANALYZE_MESHES = {"one": (), "1x1": (1, 1), "16x16": (16, 16),
                  "2x16x16": (2, 16, 16)}
SPEC_MESHES = {"1x1": (1, 1), "4x2": (4, 2), "16x16": (16, 16),
               "2x16x16": (2, 16, 16)}


def np_params(spec, seed):
    rng = np.random.default_rng(seed)

    def one(p):
        x = rng.standard_normal(p.shape).astype(np.float32)
        if p.init == "ones":
            return 1 + 0.1 * x
        if p.init == "zeros":
            return 0.1 * x
        return WEIGHT_STD * x
    return common.tree_map(one, spec, lambda x: isinstance(x, common.P))


def np_cache(shape, seed, index=INDEX):
    """A half-filled cache: bf16 values at the positions before ``index``,
    zeros from it on; as ``ml_dtypes.bfloat16`` numpy, the reference
    state's own dtype."""
    rng = np.random.default_rng(seed)

    def one():
        x = rng.standard_normal(shape).astype(np.float32)
        x[..., index:, :, :] = 0
        return x.astype(ml_dtypes.bfloat16)
    return jattention.KVCache(one(), one())


def smoke(arch, **kw):
    return (configs.get_smoke(arch).replace(**kw),
            jconfigs.get_smoke(arch).replace(**kw))


def rel(got, want) -> float:
    got = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def both_models(arch, seed, **kw):
    """``(cfg, jcfg, port Model, reference Model, port params, reference
    params)`` on one numpy draw."""
    cfg, jcfg = smoke(arch, **kw)
    model, jmodel = lm.Model(cfg), jlm.build(jcfg)
    arrays = np_params(model.spec(), seed)
    return (cfg, jcfg, model, jmodel,
            lm_params_from_arrays(arrays, cfg=cfg, device="cpu"),
            jax.tree.map(jnp.asarray, arrays))


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode_step(arch):
    """Layer 0's attention: the output within F32_RTOL of its largest
    |entry|, the cache after the step within one bf16 ulp (the rows
    before ``index`` untouched, bitwise)."""
    cfg, jcfg, model, _, params, jparams = both_models(arch, 1)
    acfg = lm._attn_cfg(cfg)
    jacfg = jlm._attn_cfg(jcfg)
    p = lm.layer_params(params["layers"], 0)["attn"]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    x = np.random.default_rng(2).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    jc = np_cache((B, S, cfg.kv_heads, acfg.head_dim), 3)
    cache = kv_cache_from_arrays(jc, device="cpu")
    out, cache = attention.decode_step(
        p, torch.from_numpy(x), cache,
        torch.tensor(INDEX, dtype=torch.int32), acfg)
    jout, jcache = jattention.decode_step(
        jp, jnp.asarray(x), jattention.KVCache(*map(jnp.asarray, jc)),
        jnp.int32(INDEX), jacfg)
    assert out.shape == (B, 1, cfg.d_model) and out.dtype == torch.float32
    assert rel(out, jout) <= F32_RTOL
    for got, want, before in zip(cache, jcache, jc):
        assert got.dtype == torch.bfloat16
        assert within_one_bf16_ulp(got, want)
        np.testing.assert_array_equal(
            got[:, :INDEX].to(torch.float32).numpy(),
            np.asarray(before, np.float32)[:, :INDEX])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_decode_step(arch, dtype):
    """The whole stack from one half-filled cache: the logits within
    F32_RTOL of the largest |logit|, the cache within one bf16 ulp and
    the next tokens equal; in bf16 (the second layer's k and v made from
    bf16 sums) the logits and the new rows within BF16_NET_RTOL of their
    largest |entry|. The state written in place."""
    cfg, jcfg, model, jmodel, params, jparams = both_models(
        arch, 4, compute_dtype=dtype)
    jc = np_cache(tuple(model.decode_state_spec(B, S).k.shape), 5)
    state = kv_cache_from_arrays(jc, device="cpu")
    k_before = state.k
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab, (B, 1)).astype(np.int32)
    logits, state = model.decode_step(params, state, lm.DecodeBatch(
        torch.from_numpy(tokens), torch.tensor(INDEX, dtype=torch.int32)))
    jlogits, jstate = jax.jit(jmodel.decode_step)(
        jparams, jattention.KVCache(*map(jnp.asarray, jc)),
        jlm.DecodeBatch(jnp.asarray(tokens), jnp.int32(INDEX)))
    assert state.k is k_before
    assert logits.shape == (B, 1, cfg.vocab)
    assert logits.dtype == lm.dtype_of(dtype)
    assert rel(logits, jlogits) <= (F32_RTOL if dtype == "float32"
                                    else BF16_NET_RTOL)
    for got, want in zip(state, jstate):
        if dtype == "float32":
            assert within_one_bf16_ulp(got, want)
        else:
            assert rel(got[:, :, INDEX], np.asarray(want, np.float32)[
                :, :, INDEX]) <= BF16_NET_RTOL
            np.testing.assert_array_equal(
                got[:, :, :INDEX].to(torch.float32).numpy(),
                np.asarray(want, np.float32)[:, :, :INDEX])
    if dtype == "float32":
        np.testing.assert_array_equal(
            logits[:, -1].argmax(-1).numpy(),
            np.asarray(jlogits, np.float32)[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The decode logits after t tokens (a fresh cache, one token at a
    time) against ``Model.forward``'s at position t, as the reference's
    own test does: its tolerance, ``Model.init``'s weights, and the cache
    cast to float32 for the float32 smoke config (in bf16 the rounding of
    k and v moves these configs' sharp softmaxes by several percent of the
    largest |logit|, in both packages)."""
    cfg = configs.get_smoke(arch)
    model = lm.Model(cfg)
    params = model.init(torch.Generator().manual_seed(7))
    seq = 8
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (B, seq)).astype(np.int32))
    full = model.forward(params, lm.Batch(tokens, None))
    state = attention.KVCache(*(t.to(torch.float32) for t in
                                model.init_decode_state(B, seq,
                                                        device="cpu")))
    outs = []
    for t in range(seq):
        logits, state = model.decode_step(params, state, lm.DecodeBatch(
            tokens[:, t:t + 1], torch.tensor(t, dtype=torch.int32)))
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_equals_the_reference(arch):
    """Prompts of 5 tokens, 7 generated, in a cache of 12: every token."""
    cfg, _, model, jmodel, params, jparams = both_models(arch, 9)
    prompts = np.random.default_rng(10).integers(
        0, cfg.vocab, (B, 5)).astype(np.int32)
    got = decode.greedy_decode(model, params, torch.from_numpy(prompts), 7,
                               max_seq=12)
    want = jdecode.greedy_decode(jmodel, jparams, jnp.asarray(prompts), 7,
                                 max_seq=12)
    assert got.dtype == torch.int32 and got.shape == (B, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :5].numpy(), prompts)


def test_the_launcher_prints_greedy_decodes_tokens(capsys):
    """``main`` on the CPU: its last line holds the tokens
    ``greedy_decode`` gives on the same seeds."""
    import json
    assert decode.main(["--arch", "olmo-1b", "--smoke", "--batch", "2",
                        "--prompt-len", "3", "--gen", "4",
                        "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])["tokens"]
    cfg = configs.get_smoke("olmo-1b")
    model = lm.Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (2, 3), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    want = decode.greedy_decode(model, params, prompts, 4, max_seq=7)
    assert got == want.tolist()


def test_the_decode_step_makes_no_host_sync():
    """The step's source reads nothing back to the host: no ``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()``, and no ``int(``, ``float(``
    or ``bool(`` of a tensor, in any function a step runs."""
    cell = steps.build_decode_cell(configs.get_smoke("internlm2-1.8b"),
                                   configs.ShapeConfig("d", S, B, "decode"))
    fns = [attention.decode_step, attention._write,
           attention._decode_attend, attention._heads_block,
           attention._scores, attention._project_qkv,
           lm._tf_layer_decode, lm.Model.decode_step, cell.step_fn,
           decode.greedy_decode]
    for fn in fns:
        src = inspect.getsource(fn)
        for bad in (".item()", ".cpu()", ".tolist()", ".numpy()", "int(",
                    "float(", "bool("):
            assert bad not in src, (fn.__name__, bad)


def test_kv_cache_from_arrays():
    """A bf16 state passes exactly, on the device asked for; float32
    leaves are rounded to bf16."""
    jc = np_cache((2, 3, 4, 5, 8), 11, index=5)
    got = kv_cache_from_arrays(jc, device="cpu")
    assert isinstance(got, attention.KVCache)
    for g, w in zip(got, jc):
        assert g.dtype == torch.bfloat16 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                      np.asarray(w, np.float32))
    x = np.float32(1 + 2 ** -12)
    one = kv_cache_from_arrays(jattention.KVCache(np.full((1,), x),
                                                  np.full((1,), x)),
                               device="cpu")
    assert float(one.k[0]) == 1.0


# ---------------------------------------------------------------------------
# the state, the cell, the memory model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_equals_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    got = lm.Model(cfg).decode_state_spec(128, 32768)
    want = jlm.build(jcfg).decode_state_spec(128, 32768)
    for g, w in zip(got, want):
        assert g.device.type == "meta" and g.dtype == torch.bfloat16
        assert tuple(g.shape) == tuple(w.shape) and str(w.dtype) == \
            "bfloat16"
    zeros = lm.Model(configs.get_smoke(arch)).init_decode_state(
        2, 8, device="cpu")
    assert all(t.dtype == torch.bfloat16 and not t.any() for t in zeros)
    one = attention.init_cache(lm._attn_cfg(cfg), 2, 8, device="cpu")
    jone = jattention.init_cache(jlm._attn_cfg(jcfg), 2, 8)
    for g, w in zip(one, jone):
        assert g.dtype == torch.bfloat16 and not g.any()
        assert tuple(g.shape) == tuple(w.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    sh, jsh = configs.SHAPES["decode_32k"], jconfigs.SHAPES["decode_32k"]
    same_meta(abstract_tree(steps.input_specs(configs.get_config(arch), sh)),
              jsteps.input_specs(jconfigs.get_config(arch), jsh))


def spec_meshes(shape):
    names = (("data", "model") if len(shape) == 2
             else ("pod", "data", "model"))
    return (jax.sharding.AbstractMesh(shape, names),
            dict(zip(names, shape)))


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_equals_the_reference(arch, mesh):
    """Abstract arguments, input and output spec trees (the cache by kv
    heads or along the sequence, as the reference's rules resolve it),
    donation."""
    jm, tm = spec_meshes(SPEC_MESHES[mesh])
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


def test_the_encoder_and_the_other_families_raise():
    """The encoder has no decode step (``ValueError``, as the reference),
    nor an unknown family; the dense, MoE, VLM, hybrid and xLSTM families
    decode."""
    cfg = configs.get_config("hubert-xlarge")
    sh = configs.SHAPES["decode_32k"]
    for fn in (steps.build_cell, steps.input_specs):
        with pytest.raises(ValueError, match="no decode step"):
            fn(cfg, sh)
    with pytest.raises(ValueError, match="no decode step"):
        mm.analyze(cfg, sh, {"data": 16, "model": 16})
    with pytest.raises(ValueError, match="no decode step"):
        jsteps.input_specs(jconfigs.get_config("hubert-xlarge"),
                           jconfigs.SHAPES["decode_32k"])
    base = configs.get_smoke("internlm2-1.8b")
    with pytest.raises(ValueError, match=re.escape("'rnn'")):
        lm.check_decodes(base.replace(family="rnn"))
    lm.check_decodes(base.replace(family="ssm"))
    lm.check_decodes(configs.get_config("xlstm-350m"))
    lm.check_decodes(base)
    lm.check_decodes(configs.get_config("zamba2-1.2b"))
    lm.check_decodes(base.replace(family="moe", n_experts=4, top_k=2))
    lm.check_decodes(configs.get_config("qwen3-moe-235b-a22b"))


@pytest.mark.parametrize("rules", [None, {"act_kv_heads": None}])
@pytest.mark.parametrize("mesh", list(ANALYZE_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analyze_decode_equals_the_reference(arch, mesh, rules):
    """Term by term, on Python integers: equal. The rules override puts
    the cache along the sequence for every architecture."""
    shape = ANALYZE_MESHES[mesh]
    names = {0: (), 2: ("data", "model"), 3: ("pod", "data", "model")}[
        len(shape)]
    jm = jax.sharding.AbstractMesh(shape, names)
    got = mm.analyze(configs.get_config(arch), configs.SHAPES["decode_32k"],
                     dict(zip(names, shape)), rules)
    want = jmm.analyze(jconfigs.get_config(arch),
                       jconfigs.SHAPES["decode_32k"], jm, rules)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.state_gb > 0 and got.total_gb == want.total_gb


def decode_flops(cfg, b: int, s: int) -> int:
    """One token a sequence: per layer q, k, v, o, the scores and ``P·V``
    over the whole cache, the MLP; the unembedding."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    n_in = 2 if cfg.activation == "silu" else 1
    layer = (2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
             + 2 * 2 * h * s * hd + n_in * 2 * d * cfg.d_ff
             + 2 * cfg.d_ff * d)
    return b * (cfg.n_layers * layer + 2 * d * cfg.vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell_flops_are_the_hand_count(arch):
    """The full config's unsharded decode cell at ``decode_32k``, counted
    on meta tensors."""
    cfg = configs.get_config(arch)
    sh = configs.SHAPES["decode_32k"]
    cell = steps.build_cell(cfg, sh)
    with FlopCounterMode(display=False) as fc:
        tokens, state = cell.step_fn(*cell.abstract_args)
    assert tuple(tokens.shape) == (sh.global_batch,)
    assert tokens.dtype == torch.int32
    assert state is cell.abstract_args[1]
    assert fc.get_total_flops() == decode_flops(cfg, sh.global_batch,
                                                sh.seq_len)

