"""PyTorch port, the dense and vlm families of the LM zoo: ``olmo-1b``,
``codeqwen1.5-7b``, ``internlm2-1.8b``, ``deepseek-67b`` and
``internvl2-76b`` through ``repro_torch.models`` and
``repro_torch.launch.steps``, against ``repro.models.lm`` and
``repro.launch.steps`` on the same numpy inputs.

Each architecture's smoke config: ``spec`` and ``param_specs`` against
the reference's ``spec`` and ``param_shardings`` on (1, 1), (8, 1),
(4, 2) and 16x16 meshes; ``Model.forward``'s logits (float32 within
``F32_RTOL``, bf16 within ``BF16_NET_RTOL`` of the largest |logit|);
``Model.loss`` within ``LOSS_RTOL`` relative and each gradient leaf
within ``GRAD_RTOL`` of its largest |entry|; one train step from a
mid-run AdamW state, its parameters and moments within ``GRAD_RTOL``. The
full configs: ``analyze()`` term by term, ``model_flops`` and
``active_params`` at ``train_4k`` and ``prefill_32k`` on 1x1, 16x16 and
2x16x16. Also the VLM's text-only logits and its loss over the text
positions alone, the token embedding against ``jnp.take``, the FLOPs of
the causal cells on meta tensors against a hand count that follows the
query blocks, and a head placement the grouped-query split refuses.

The weights are drawn at ``WEIGHT_STD`` (norm scales ``1 + 0.1 N``),
where the float32 problem is well conditioned, as in
``tests/test_torch_cells.py``; the embedding table at the same scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.distributed import memory_model as jmm
from repro.distributed import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import adamw_state_from_arrays, lm_params_from_arrays
from repro_torch.distributed import memory_model as mm
from repro_torch.distributed import roofline
from repro_torch.launch import dryrun, steps
from repro_torch.models import attention, common, lm

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ARCHS = ["olmo-1b", "codeqwen1.5-7b", "internlm2-1.8b", "deepseek-67b",
         "internvl2-76b"]
WEIGHT_STD = 0.2
F32_RTOL = 1e-5
BF16_NET_RTOL = 5e-2
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
MID_RUN_STEP = 2400
#: (batch, text positions) of the smoke inputs
B, S = 2, 24
SPEC_MESHES = {"1x1": (1, 1), "8x1": (8, 1), "4x2": (4, 2),
               "16x16": (16, 16)}
ANALYZE_MESHES = {"1x1": (1, 1), "16x16": (16, 16), "2x16x16": (2, 16, 16)}


def abstract_meshes(shape):
    """``(reference AbstractMesh, the port's {name: size})``."""
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return (jax.sharding.AbstractMesh(shape, names),
            dict(zip(names, shape)))


def np_params(spec, seed, std=WEIGHT_STD):
    rng = np.random.default_rng(seed)

    def one(p):
        x = rng.standard_normal(p.shape).astype(np.float32)
        if p.init == "ones":
            return 1 + 0.1 * x
        if p.init == "zeros":
            return 0.1 * x
        return std * x
    return common.tree_map(one, spec, lambda x: isinstance(x, common.P))


def np_batch(cfg, seed, b=B, s=S):
    """Tokens, labels in ``[-1, vocab)`` and, for the VLM, its image
    prefix: the reference's ``Batch`` and the port's."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (b, s)).astype(np.int32)
    img = (rng.standard_normal((b, cfg.n_image_tokens, cfg.d_model))
           .astype(np.float32) if cfg.family == "vlm" else None)
    return (jlm.Batch(jnp.asarray(tokens), jnp.asarray(labels),
                      None if img is None else jnp.asarray(img)),
            lm.Batch(torch.from_numpy(tokens), torch.from_numpy(labels),
                     None if img is None else torch.from_numpy(img)))


def rel(got, want) -> float:
    got = np.asarray(got.detach().to(torch.float32) if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def smoke(arch, **kw):
    return (configs.get_smoke(arch).replace(**kw),
            jconfigs.get_smoke(arch).replace(**kw))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def spec_entries(spec, is_p):
    out = {}

    def walk(node, path):
        if is_p(node):
            out[path] = (tuple(node.shape), tuple(node.axes), node.init,
                         node.scale)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        else:
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
    walk(spec, "")
    return out


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_and_param_specs_equal_the_reference(arch, mesh):
    """Every declared leaf (the empty norm subtrees of OLMo among the
    paths: no leaf in either) and its spec on the mesh."""
    cfg, jcfg = smoke(arch)
    model, jmodel = lm.Model(cfg), jlm.build(jcfg)
    assert spec_entries(model.spec(), lambda x: isinstance(x, common.P)) \
        == spec_entries(jmodel.spec(), lambda x: isinstance(x, jcommon.P))
    jm, tm = abstract_meshes(SPEC_MESHES[mesh])
    got = []
    common.tree_map(got.append, model.param_specs(tm),
                    lambda x: isinstance(x, tuple))
    want = jax.tree.leaves(jmodel.param_shardings(jm))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a == tuple(b.spec)


def test_grouped_query_split_leaves_the_kv_heads_whole():
    """The placements the split serves: internlm2's smoke config on a
    (1, 4) mesh and the full internlm2, deepseek and internvl2 on 16x16
    split the query heads over "model" and leave the kv heads whole."""
    spec = lm.Model(configs.get_smoke("internlm2-1.8b")).param_specs(
        {"data": 1, "model": 4})
    attn = spec["layers"]["attn"]
    assert attn["wq"][2] == "model" and attn["wk"][2] is None
    for arch in ("internlm2-1.8b", "deepseek-67b", "internvl2-76b"):
        spec = lm.Model(configs.get_config(arch)).param_specs(
            {"data": 16, "model": 16})
        attn = spec["layers"]["attn"]
        assert attn["wq"][2] == "model" and attn["wk"][2] is None \
            and attn["wv"][2] is None


def test_olmo_norms_are_empty_subtrees():
    cfg = configs.get_smoke("olmo-1b")
    spec = lm.Model(cfg).spec()
    assert spec["final_norm"] == {} and spec["layers"]["attn_norm"] == {}
    params = lm_params_from_arrays(np_params(spec, 0), cfg=cfg, device="cpu")
    assert params["final_norm"] == {} and params["layers"]["mlp_norm"] == {}
    state = steps.make_optimizer(cfg).init(params)
    assert state.mu["layers"]["attn_norm"] == {}


# ---------------------------------------------------------------------------
# the token embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_is_jnp_take(dtype):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 12)).astype(np.float32)
    tokens = rng.integers(0, 50, (3, 7)).astype(np.int32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jcommon.embed({"embedding": jnp.asarray(table)},
                         jnp.asarray(tokens), jd)
    got = common.embed({"embedding": torch.from_numpy(table)},
                       torch.from_numpy(tokens), td)
    assert got.dtype == td
    np.testing.assert_array_equal(
        got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32)))
    decl, jdecl = common.embed_spec(50, 12), jcommon.embed_spec(50, 12)
    assert tuple(decl["embedding"]) == tuple(jdecl["embedding"])


# ---------------------------------------------------------------------------
# forward, loss, gradients and a train step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch, dtype):
    cfg, jcfg = smoke(arch, compute_dtype=dtype)
    arrays = np_params(lm.Model(cfg).spec(), 2)
    jb, tb = np_batch(cfg, 3)
    want, _ = jlm.build(jcfg).forward(jax.tree.map(jnp.asarray, arrays), jb)
    got = lm.Model(cfg).forward(
        lm_params_from_arrays(arrays, cfg=cfg, device="cpu"), tb)
    assert tuple(got.shape) == (B, S, cfg.vocab)
    assert got.dtype == lm.dtype_of(dtype)
    assert rel(got, want) <= (F32_RTOL if dtype == "float32"
                              else BF16_NET_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    cfg, jcfg = smoke(arch)
    arrays = np_params(lm.Model(cfg).spec(), 4)
    jb, tb = np_batch(cfg, 5)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.build(jcfg).loss(p, jb)))(
            jax.tree.map(jnp.asarray, arrays))
    params = common.tree_map(
        lambda a: a.requires_grad_(),
        lm_params_from_arrays(arrays, cfg=cfg, device="cpu"))
    loss = lm.Model(cfg).loss(params, tb)
    grads = torch.autograd.grad(loss, common.leaves(params))
    loss = loss.detach()
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        assert rel(g, w) <= GRAD_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_from_a_mid_run_state(arch):
    """Two reference steps from the drawn weights, the step counter then
    set past the warmup; one more step in both packages from that state."""
    cfg, jcfg = smoke(arch)
    arrays = np_params(lm.Model(cfg).spec(), 6)
    jb, tb = np_batch(cfg, 7)
    mesh = jax.sharding.AbstractMesh((1, 1), ("data", "model"))
    jstep = jax.jit(jsteps.build_train_cell(jcfg, jconfigs.SMOKE_SHAPE,
                                            mesh).step_fn)
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
        g_leaves, w_leaves = common.leaves(got), jax.tree.leaves(want)
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            assert g.dtype == torch.float32
            assert rel(g, w) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# the image prefix
# ---------------------------------------------------------------------------

def test_vlm_logits_and_loss_cover_the_text_alone():
    """The VLM's logits are its text positions' (the prefill cell's
    output shape too), its loss the NLL of those logits alone; another
    image prefix changes the text logits."""
    cfg, jcfg = smoke("internvl2-76b")
    model = lm.Model(cfg)
    params = lm_params_from_arrays(np_params(model.spec(), 8), cfg=cfg,
                                   device="cpu")
    _, tb = np_batch(cfg, 9)
    logits = model.forward(params, tb)
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    lab = tb.labels.to(torch.int64)
    mask = lab >= 0
    nll = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, lab.clamp(min=0)[..., None])[..., 0])[mask]
    assert float(model.loss(params, tb)) == pytest.approx(
        float(nll.mean()), rel=1e-6)
    other = tb._replace(embeds=tb.embeds.flip(1))
    assert not torch.allclose(model.forward(params, other), logits)
    no_image = model.forward(params, tb._replace(embeds=None))
    assert tuple(no_image.shape) == (B, S, cfg.vocab)
    cell = steps.build_cell(cfg, configs.SHAPES["prefill_32k"],
                            {"data": 16, "model": 16})
    jcell = jsteps.build_cell(jcfg, jconfigs.SHAPES["prefill_32k"],
                              abstract_meshes((16, 16))[0])
    assert cell.out_shardings == tuple(jcell.out_shardings.spec)
    img = cell.abstract_args[1].embeds
    assert tuple(img.shape) == (32, cfg.n_image_tokens, cfg.d_model)
    assert cell.in_shardings[1].embeds == tuple(
        jcell.in_shardings[1].embeds.spec)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_input_specs_equal_the_reference(arch, shape):
    got = steps.input_specs(configs.get_config(arch), configs.SHAPES[shape])
    want = jsteps.input_specs(jconfigs.get_config(arch),
                              jconfigs.SHAPES[shape])
    tb, jb = got[-1], want[-1]
    for a, b in zip(tb, jb):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


# ---------------------------------------------------------------------------
# the memory model and the roofline's model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(ANALYZE_MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_analyze_and_model_flops_equal_the_reference(arch, shape, mesh):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    jm, tm = abstract_meshes(ANALYZE_MESHES[mesh])
    got = mm.analyze(cfg, configs.SHAPES[shape], tm)
    want = jmm.analyze(jcfg, jconfigs.SHAPES[shape], jm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_gb == want.total_gb
    n = common.spec_param_count(lm.Model(cfg).spec())
    assert n == jcommon.spec_param_count(jlm.build(jcfg).spec())
    assert roofline.active_params(cfg, n) == jroofline.active_params(jcfg, n)
    assert roofline.model_flops(cfg, configs.SHAPES[shape], n) == \
        jroofline.model_flops(jcfg, jconfigs.SHAPES[shape], n)


# ---------------------------------------------------------------------------
# the cells counted on meta tensors
# ---------------------------------------------------------------------------

def attn_pairs(S_all: int, q_chunk: int = 1024) -> int:
    """(query, key) pairs the causal attention scores: the whole square
    in one block, else each query block ``[lo, hi)`` against its first
    ``hi`` keys (``attention._sdpa``), the ragged last block included."""
    if S_all <= q_chunk:
        return S_all * S_all
    return sum((min(lo + q_chunk, S_all) - lo) * min(lo + q_chunk, S_all)
               for lo in range(0, S_all, q_chunk))


def causal_flops(cfg, b: int, s: int, train: bool) -> int:
    """Hand count of a dense or vlm cell's products: per layer q, k, v, o,
    the MLP (SwiGLU: three products) over the image and text positions, the scores and ``P·V`` over
    :func:`attn_pairs`; the unembedding over the text positions. Train:
    three times the forward, each layer's remat recompute up to
    ``w_down``, and the chunked loss's recompute of the unembedding."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    S_all = s + (cfg.n_image_tokens if cfg.family == "vlm" else 0)
    T = b * S_all
    down = 2 * T * cfg.d_ff * d
    n_in = 2 if cfg.activation == "silu" else 1   # SwiGLU: gate and up
    layer = (2 * T * d * (h + 2 * kv) * hd + 2 * T * h * hd * d
             + 2 * 2 * b * attn_pairs(S_all) * h * hd
             + n_in * 2 * T * d * cfg.d_ff + down)
    unembed = 2 * b * s * d * cfg.vocab
    fwd = cfg.n_layers * layer + unembed
    if not train:
        return fwd
    chunked = cfg.vocab >= 8192 and s > 1024 and s % 1024 == 0
    return (3 * fwd + (cfg.n_layers * (layer - down)
                       if cfg.remat == "full" else 0)
            + (unembed if chunked else 0))


def test_attn_pairs_follow_the_query_blocks():
    assert attn_pairs(64) == 64 * 64
    assert attn_pairs(4096) == 1024 * 1024 * (1 + 2 + 3 + 4)
    assert attn_pairs(4352) == 1024 * 1024 * 10 + 256 * 4352


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_flops_are_the_causal_hand_count(arch):
    cfg = configs.get_smoke(arch)
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        sh = configs.SMOKE_SHAPE
        for kind in ("train", "prefill"):
            cell = steps.build_cell(c, dataclasses.replace(sh, kind=kind))
            with FlopCounterMode(display=False) as fc:
                cell.step_fn(*cell.abstract_args)
            assert fc.get_total_flops() == causal_flops(
                c, sh.global_batch, sh.seq_len, kind == "train")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "internvl2-76b"])
def test_train_flops_with_the_ragged_tail_and_the_chunked_loss(arch):
    """train_4k's sequence at 2 layers and its full width, batch 1: four
    query blocks (the VLM: a fifth of 256 behind its 256 image tokens)
    and four checkpointed loss chunks."""
    cfg = configs.get_config(arch).replace(n_layers=2)
    sh = dataclasses.replace(configs.SHAPES["train_4k"], global_batch=1)
    cell = steps.build_cell(cfg, sh)
    with FlopCounterMode(display=False) as fc:
        cell.step_fn(*cell.abstract_args)
    assert fc.get_total_flops() == causal_flops(cfg, 1, sh.seq_len, True)


# ---------------------------------------------------------------------------
# the grouped-query split's placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,kv,model,ok", [
    (6, 2, 3, False),     # rank 1's heads [2, 4) straddle two groups
    (8, 2, 4, True),      # two heads a rank inside a group of four
    (4, 2, 4, True),      # internlm2's smoke config on (1, 4)
])
def test_misaligned_head_placement_is_refused(heads, kv, model, ok):
    cfg = configs.get_smoke("internlm2-1.8b").replace(
        d_model=8 * heads, n_heads=heads, kv_heads=kv, n_layers=1)
    acfg = lm._attn_cfg(cfg)
    with dryrun.fake_world(model):
        mesh = init_device_mesh("cpu", (1, model),
                                mesh_dim_names=("data", "model"))
        group = mesh.get_group("model")
        if ok:
            lo, hi = attention.kv_heads_of_rank(acfg, group)
            assert (lo, hi) == (0, 1)
            rec = dryrun.count_cell(cfg, configs.SMOKE_SHAPE, mesh, "1x4")
            assert rec["status"] == "ok"
        else:
            with pytest.raises(ValueError, match="neither fill"):
                attention.kv_heads_of_rank(acfg, group)
            with pytest.raises(ValueError, match="neither fill"):
                dryrun.count_cell(cfg, configs.SMOKE_SHAPE, mesh, "1x3")
