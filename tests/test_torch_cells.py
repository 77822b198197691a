"""PyTorch port, the encoder's training path: the shape cells of
``repro_torch.configs``, the train and prefill cells of
``repro_torch.launch.steps``, ``Model.loss`` and the train step, against
``repro.configs``, ``repro.launch.steps`` and ``repro.models.lm``.

Cells: the port's meta tensors against the reference's
``ShapeDtypeStruct``s, and every spec leaf against the reference's
``NamedSharding.spec`` on a ``jax.sharding.AbstractMesh`` of the same
shape (the port takes a ``{name: size}`` mapping).

Numbers: every input is a ``np.random.default_rng`` array. The weights
are drawn at ``WEIGHT_STD`` (norm scales ``1 + 0.1 N``, biases ``0.1 N``),
where the float32 problem is well conditioned: at the reference's own
init (``fan_in ** -0.5`` over the head count) the attention is near
one-hot, and a 1e-7 relative change of the weights alone moves the smoke
config's gradients by more than ``GRAD_RTOL`` of their largest entry
(``test_reference_init_is_ill_conditioned``).
Tolerances: ``Model.loss`` within ``LOSS_RTOL`` relative, each gradient
leaf within ``GRAD_RTOL`` of its largest |entry| (float32: the packages
sum in another order); one train step's loss within ``LOSS_RTOL``, its
parameters and moments within ``STEP_RTOL`` of each leaf's largest
|entry|. The step is held to the gradients' tolerance, not the loss's:
AdamW divides each element's first moment by the root of its second, so
a gradient's last-bit differences come back larger on the elements whose
second moment is small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import adamw_state_from_arrays, lm_params_from_arrays
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.models import common, lm

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

ARCH = "hubert-xlarge"
WEIGHT_STD = 0.2
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
STEP_RTOL = GRAD_RTOL
MESHES = {"1x1": (1, 1), "1x4": (1, 4), "2x2": (2, 2), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}
#: the reference's optimizer state is taken this far into the run
MID_RUN_STEP = 2400


def meshes(name):
    """``(reference AbstractMesh, the port's {name: size})`` of a shape."""
    shape = MESHES[name]
    names = (("data", "model") if len(shape) == 2
             else ("pod", "data", "model"))
    return (jax.sharding.AbstractMesh(shape, names),
            dict(zip(names, shape)))


def np_params(spec, seed, std=WEIGHT_STD):
    """A numpy tree of ``spec``: normal leaves ``std · N(0, 1)``, norm
    scales ``1 + 0.1 N``, biases ``0.1 N``."""
    rng = np.random.default_rng(seed)

    def one(p):
        x = rng.standard_normal(p.shape).astype(np.float32)
        if p.init == "ones":
            return 1 + 0.1 * x
        if p.init == "zeros":
            return 0.1 * x
        return std * x
    return common.tree_map(one, spec, lambda x: isinstance(x, common.P))


def np_batch(seed, b, s, d, vocab):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, s, d)).astype(np.float32)
    labels = rng.integers(-1, vocab, (b, s)).astype(np.int32)
    return (jlm.Batch(tokens=None, labels=jnp.asarray(labels),
                      embeds=jnp.asarray(emb)),
            lm.Batch(None, torch.from_numpy(labels), torch.from_numpy(emb)))


def leaf_err(got, want) -> float:
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def loss_and_grads(model, params, batch):
    p = common.tree_map(lambda a: a.detach().clone().requires_grad_(),
                        params)
    loss = model.loss(p, batch)
    return loss.detach(), torch.autograd.grad(loss, common.leaves(p))


# ---------------------------------------------------------------------------
# shape cells
# ---------------------------------------------------------------------------

def test_shapes_equal_the_reference():
    assert configs.SHAPES == {k: configs.ShapeConfig(*v.__dict__.values())
                              for k, v in jconfigs.SHAPES.items()}
    assert tuple(configs.SMOKE_SHAPE.__dict__.values()) == \
        tuple(jconfigs.SMOKE_SHAPE.__dict__.values())
    assert configs.SKIP_REASONS == jbase.SKIP_REASONS


@pytest.mark.parametrize("family", ["encoder", "dense", "hybrid", "ssm"])
def test_applicable_shapes_equal_the_reference(family):
    enc = family == "encoder"
    cfg = configs.get_config(ARCH).replace(family=family, is_encoder=enc)
    jcfg = jconfigs.get_config(ARCH).replace(family=family, is_encoder=enc)
    got = configs.applicable_shapes(cfg)
    want = jconfigs.applicable_shapes(jcfg)
    assert {k: v and v.name for k, v in got.items()} == \
        {k: v and v.name for k, v in want.items()}


# ---------------------------------------------------------------------------
# cells: meta tensors and spec trees
# ---------------------------------------------------------------------------

def same_meta(got, want):
    """Meta tensors against ``ShapeDtypeStruct``s, leaf by leaf (a None
    input, such as an embeds-in batch's tokens, is no leaf in either)."""
    g = [x for x in common.leaves(got) if x is not None]
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


def abstract_tree(args):
    """A cell's abstract arguments as nested lists (NamedTuples opened,
    None kept as a leaf)."""
    if isinstance(args, tuple) and hasattr(args, "_fields"):
        return [abstract_tree(a) for a in args]
    if isinstance(args, (list, tuple)):
        return [abstract_tree(a) for a in args]
    if isinstance(args, dict):
        return {k: abstract_tree(args[k]) for k in sorted(args)}
    return args


@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_abstract_params_equal_the_reference(which):
    cfg, jcfg = getattr(configs, which)(ARCH), getattr(jconfigs, which)(ARCH)
    model, jmodel = lm.Model(cfg), jlm.build(jcfg)
    same_meta(model.abstract_params(), jmodel.abstract_params())
    assert common.spec_param_count(model.spec()) == \
        jcommon.spec_param_count(jmodel.spec())


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "smoke"])
def test_input_specs_equal_the_reference(shape):
    sh = configs.SMOKE_SHAPE if shape == "smoke" else configs.SHAPES[shape]
    jsh = (jconfigs.SMOKE_SHAPE if shape == "smoke"
           else jconfigs.SHAPES[shape])
    got = steps.input_specs(configs.get_config(ARCH), sh)
    want = jsteps.input_specs(jconfigs.get_config(ARCH), jsh)
    same_meta(abstract_tree(got), want)
    assert got[-1].tokens is None and want[-1].tokens is None


def spec_leaves(tree):
    """The spec tuples of a cell's sharding tree, in order; a ``None``
    entry (no tensor) kept."""
    out = []

    def is_spec(x):
        return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
            e is None or isinstance(e, str)
            or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
            for e in x)

    def walk(x):
        if x is None or is_spec(x):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        else:
            for v in x:
                walk(v)
    walk(tree)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_build_cell_equals_the_reference(shape, mesh):
    """Abstract arguments, input and output spec trees, donation."""
    jm, tm = meshes(mesh)
    got = steps.build_cell(configs.get_config(ARCH),
                           configs.SHAPES[shape], tm)
    want = jsteps.build_cell(jconfigs.get_config(ARCH),
                             jconfigs.SHAPES[shape], jm)
    same_meta(abstract_tree(got.abstract_args), want.abstract_args)
    assert got.donate_argnums == want.donate_argnums
    for g, w in ((got.in_shardings, want.in_shardings),
                 (got.out_shardings, want.out_shardings)):
        gl = spec_leaves(g)
        wl = jax.tree.leaves(w, is_leaf=lambda x: x is None)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert a == (None if b is None else tuple(b.spec))


def test_cell_on_a_one_rank_mesh_is_bitwise_the_unsharded_one():
    """Without a mesh a cell has no spec trees; on a (1, 1) ``DeviceMesh``
    of a one-rank ``gloo`` group its train and prefill steps, fed this
    rank's blocks (the whole state), are bitwise the unsharded steps:
    every collective on a one-rank group gives its input's bits back."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    cfg = configs.get_smoke(ARCH)
    shape = configs.SMOKE_SHAPE
    cell = steps.build_cell(cfg, shape)
    assert cell.in_shardings is None and cell.out_shardings is None
    arrays = np_params(lm.Model(cfg).spec(), 16)
    _, tb = np_batch(17, shape.global_batch, shape.seq_len, cfg.d_model,
                     cfg.vocab)
    params = lm_params_from_arrays(arrays, cfg=cfg, device="cpu")
    state = steps.make_optimizer(cfg).init(params)
    want = cell.step_fn(params, state, tb)
    want_logits = steps.build_cell(cfg, configs.SHAPES["prefill_32k"]
                                   ).step_fn(params, tb)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        sharded = steps.build_cell(cfg, shape, mesh)
        got = sharded.step_fn(*steps.local_args(
            (params, state, tb), sharded.in_shardings, mesh))
        pcell = steps.build_cell(cfg, configs.SHAPES["prefill_32k"], mesh)
        got_logits = pcell.step_fn(*steps.local_args(
            (params, tb), pcell.in_shardings, mesh))
    finally:
        dist.destroy_process_group()
    for a, b in zip(common.leaves(list(got)), common.leaves(list(want)),
                    strict=True):
        assert torch.equal(a, b)
    assert torch.equal(got_logits, want_logits)


def test_decode_raises_as_the_reference():
    cfg = configs.get_config(ARCH)
    with pytest.raises(ValueError, match="no decode step"):
        steps.build_cell(cfg, configs.SHAPES["decode_32k"])
    with pytest.raises(ValueError, match="no decode step"):
        steps.input_specs(cfg, configs.SHAPES["decode_32k"])
    with pytest.raises(ValueError, match="no decode step"):
        jsteps.input_specs(jconfigs.get_config(ARCH),
                           jconfigs.SHAPES["decode_32k"])


@pytest.mark.parametrize("mesh", [None, "2x2", "2x16x16"])
def test_logical_sharding(mesh):
    shape, axes = (32, 4096, 1280), ("act_batch", "act_seq", "act_embed")
    if mesh is None:
        assert sharding.logical_sharding(shape, axes) is None
        return
    jm, tm = meshes(mesh)
    from repro.distributed import sharding as jsharding
    assert sharding.logical_sharding(shape, axes, tm) == \
        tuple(jsharding.logical_sharding(shape, axes, jm).spec)
    with sharding.use_mesh(tm):
        assert sharding.logical_sharding(shape, axes) == \
            sharding.spec_for(shape, axes, tm)


# ---------------------------------------------------------------------------
# the loss, its gradients and the train step against the reference
# ---------------------------------------------------------------------------

def smoke_models():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    return jlm.build(jcfg), lm.Model(cfg)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads(masked):
    """At smoke width in float32; with ``masked``, every label -1 (the
    count clamped to 1, the loss 0)."""
    jmodel, model = smoke_models()
    arrays = np_params(model.spec(), 1)
    jb, tb = np_batch(2, 2, 64, model.cfg.d_model, model.cfg.vocab)
    if masked:
        jb = jb._replace(labels=jnp.full_like(jb.labels, -1))
        tb = tb._replace(labels=torch.full_like(tb.labels, -1))
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb)))(jax.tree.map(jnp.asarray, arrays))
    loss, grads = loss_and_grads(
        model, lm_params_from_arrays(arrays, cfg=model.cfg, device="cpu"),
        tb)
    assert loss.dtype == torch.float32 and loss.shape == ()
    if masked:
        assert float(loss) == float(want) == 0.0
        return
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        assert leaf_err(g, w) <= GRAD_RTOL


def test_reference_init_is_ill_conditioned():
    """Why the parity weights are drawn at WEIGHT_STD: at ``Model.init``'s
    scale a 1e-7 relative change of every weight moves the smoke
    config's float32 gradients by more than GRAD_RTOL within the port
    alone; at WEIGHT_STD by less."""
    _, model = smoke_models()
    _, tb = np_batch(2, 2, 64, model.cfg.d_model, model.cfg.vocab)
    rng = np.random.default_rng(15)
    for params, ill in ((model.init(torch.Generator().manual_seed(1)), True),
                        (lm_params_from_arrays(np_params(model.spec(), 1),
                                               cfg=model.cfg, device="cpu"),
                         False)):
        moved = common.tree_map(lambda a: a * torch.from_numpy(
            1 + 1e-7 * rng.standard_normal(a.shape).astype(np.float32)),
            params)
        _, g0 = loss_and_grads(model, params, tb)
        _, g1 = loss_and_grads(model, moved, tb)
        err = max(leaf_err(a, b.numpy()) for a, b in zip(g1, g0))
        assert (err > GRAD_RTOL) == ill, err


def test_chunked_loss_branch():
    """vocab 8192 over 2048 positions: the seq-chunked branch (two
    checkpointed chunks of 1024), loss and gradients."""
    jcfg = jconfigs.get_smoke(ARCH).replace(vocab=8192, d_model=16,
                                            n_heads=2, kv_heads=2, d_ff=32,
                                            n_layers=1)
    cfg = configs.get_smoke(ARCH).replace(vocab=8192, d_model=16,
                                          n_heads=2, kv_heads=2, d_ff=32,
                                          n_layers=1)
    model, jmodel = lm.Model(cfg), jlm.build(jcfg)
    s = 2048
    assert s > model._LOSS_CHUNK and s % model._LOSS_CHUNK == 0
    arrays = np_params(model.spec(), 3)
    jb, tb = np_batch(4, 1, s, cfg.d_model, cfg.vocab)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb)))(jax.tree.map(jnp.asarray, arrays))
    loss, grads = loss_and_grads(
        model, lm_params_from_arrays(arrays, cfg=cfg, device="cpu"), tb)
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        assert leaf_err(g, w) <= GRAD_RTOL


def reference_mid_run(jcfg, arrays, jb):
    """The reference's train step, jitted, two steps into a run from
    ``arrays``, its step counter then set to MID_RUN_STEP (past the
    warmup): ``(step_fn, params, opt_state)``."""
    mesh = jax.sharding.AbstractMesh((1, 1), ("data", "model"))
    step = jax.jit(jsteps.build_train_cell(jcfg, jconfigs.SMOKE_SHAPE,
                                           mesh).step_fn)
    params = jax.tree.map(jnp.asarray, arrays)
    state = jsteps.make_optimizer(jcfg).init(params)
    for _ in range(2):
        params, state, _ = step(params, state, jb)
    return step, params, state._replace(step=jnp.int32(MID_RUN_STEP))


def test_train_step_from_a_mid_run_state():
    """One step in both packages from the same converted mid-run state:
    the loss, the parameters and both moments; and the step counter."""
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    arrays = np_params(lm.Model(cfg).spec(), 5)
    jb, tb = np_batch(6, 2, 64, cfg.d_model, cfg.vocab)
    jstep, jparams, jstate = reference_mid_run(jcfg, arrays, jb)
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                   cfg=cfg, device="cpu")
    state = adamw_state_from_arrays(jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    assert state.step.dtype == torch.int32
    want_p, want_s, want_loss = jstep(jparams, jstate, jb)
    got_p, got_s, loss = steps.build_cell(cfg, configs.SMOKE_SHAPE).step_fn(
        params, state, tb)
    assert not loss.requires_grad and loss.shape == ()
    assert abs(float(loss) - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss))
    assert int(got_s.step) == int(want_s.step) == MID_RUN_STEP + 1
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        for g, w in zip(common.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.float32
            assert leaf_err(g, w) <= STEP_RTOL


def test_bf16_step_keeps_the_reference_dtypes():
    """In bf16 the gradients are taken of the cast tree (bf16), clipped
    into float32 as JAX promotes them, and the moments and master weights
    stay float32; loss within the bf16 network tolerance of the
    reference's."""
    jcfg = jconfigs.get_smoke(ARCH).replace(compute_dtype="bfloat16")
    cfg = configs.get_smoke(ARCH).replace(compute_dtype="bfloat16")
    arrays = np_params(lm.Model(cfg).spec(), 7)
    jb, tb = np_batch(8, 2, 64, cfg.d_model, cfg.vocab)
    mesh = jax.sharding.AbstractMesh((1, 1), ("data", "model"))
    jp = jax.tree.map(jnp.asarray, arrays)
    jopt = jsteps.make_optimizer(jcfg)
    _, want_s, want_loss = jax.jit(jsteps.build_train_cell(
        jcfg, jconfigs.SMOKE_SHAPE, mesh).step_fn)(jp, jopt.init(jp), jb)
    params = lm_params_from_arrays(arrays, cfg=cfg, device="cpu")
    got_p, got_s, loss = steps.build_cell(cfg, configs.SMOKE_SHAPE).step_fn(
        params, steps.make_optimizer(cfg).init(params), tb)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(want_loss)) <= 1e-2 * float(want_loss)
    for tree, jtree in ((got_p, None), (got_s.mu, want_s.mu),
                        (got_s.nu, want_s.nu)):
        for g, w in zip(common.leaves(tree),
                        jax.tree.leaves(jtree) if jtree is not None
                        else common.leaves(tree)):
            assert g.dtype == torch.float32
            if jtree is not None:
                assert str(w.dtype) == "float32"


# ---------------------------------------------------------------------------
# within the port: remat, the stacked layers, the flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_full_is_bitwise_none(dtype):
    cfg = configs.get_smoke(ARCH).replace(compute_dtype=dtype)
    arrays = np_params(lm.Model(cfg).spec(), 9)
    _, tb = np_batch(10, 2, 64, cfg.d_model, cfg.vocab)
    out = {}
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        out[remat] = steps.build_cell(c, configs.SMOKE_SHAPE).step_fn(
            lm_params_from_arrays(arrays, cfg=c, device="cpu"),
            steps.make_optimizer(c).init(
                lm_params_from_arrays(arrays, cfg=c, device="cpu")), tb)
    for a, b in zip(common.leaves(list(out["none"])),
                    common.leaves(list(out["full"]))):
        assert torch.equal(a, b)


def test_dots_remat_names_the_roadmap_item():
    """ROADMAP.md §1 item 4(f) ported "dots": the loss and gradients
    bitwise "full"'s (tests/test_torch_remat.py holds every family); an
    unknown policy is refused."""
    _, tb = np_batch(11, 1, 8, configs.get_smoke(ARCH).d_model,
                     configs.get_smoke(ARCH).vocab)
    params = lm.Model(configs.get_smoke(ARCH)).init(
        torch.Generator().manual_seed(0))
    out = {}
    for remat in ("dots", "full"):
        model = lm.Model(configs.get_smoke(ARCH).replace(remat=remat))
        ps = common.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = model.loss(ps, tb)
        out[remat] = [loss.detach(), *torch.autograd.grad(
            loss, common.leaves(ps))]
    assert all(torch.equal(a, b) for a, b in zip(out["dots"], out["full"]))
    with pytest.raises(ValueError, match="remat 'some'"):
        lm.Model(configs.get_smoke(ARCH).replace(remat="some")).loss(
            params, tb)


def test_stacked_layers_unbind_to_the_views():
    """``unbind_layers`` gives each layer the same view ``layer_params``
    does (the forward's bits kept), and the stacked tree's gradient is
    the listed trees' stacked."""
    cfg = configs.get_smoke(ARCH)
    params = lm.Model(cfg).init(torch.Generator().manual_seed(1))
    layers = params["layers"]
    for i, tree in enumerate(lm.unbind_layers(layers, cfg.n_layers)):
        for a, b in zip(common.leaves(tree),
                        common.leaves(lm.layer_params(layers, i))):
            assert a.data_ptr() == b.data_ptr() and a.shape == b.shape \
                and a.stride() == b.stride()
    _, tb = np_batch(12, 2, 16, cfg.d_model, cfg.vocab)
    listed = dict(params, layers=[
        common.tree_map(lambda a: a.clone(), lm.layer_params(layers, i))
        for i in range(cfg.n_layers)])
    model = lm.Model(cfg)
    loss_s, g_s = loss_and_grads(model, params, tb)
    loss_l, g_l = loss_and_grads(lm.Model(cfg.replace(scan_layers=False)),
                                 listed, tb)
    assert torch.equal(loss_s, loss_l)
    stacked = dict(zip(map(id, common.leaves(params)), g_s))
    got = common.tree_map(lambda a: stacked[id(a)], params)
    per_layer = iter(g_l)
    want = common.tree_map(lambda a: next(per_layer), listed)
    for k in ("final_norm", "unembed"):
        for a, b in zip(common.leaves(got[k]), common.leaves(want[k])):
            assert torch.equal(a, b)
    for leaf, rows in zip(common.leaves(got["layers"]),
                          zip(*[common.leaves(t) for t in want["layers"]])):
        assert torch.equal(leaf, torch.stack(rows))


MATMUL = torch.backends.cuda.matmul
PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default}


class FlagsAtProducts(TorchDispatchMode):
    """Records the matmul flags at every product the dispatcher runs, the
    backward pass's and the remat recompute's included."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.seen.append((MATMUL.allow_tf32,
                              MATMUL.allow_bf16_reduced_precision_reduction))
        return func(*args, **(kwargs or {}))


def test_train_step_pins_the_flags_through_the_backward_pass():
    """The caller's flags set away from the pinned ones: every product of
    the step (forward, remat recompute, backward) sees them pinned, the
    caller's come back, and the step's bits are those under the
    defaults."""
    cfg = configs.get_smoke(ARCH).replace(remat="full")
    arrays = np_params(lm.Model(cfg).spec(), 13)
    _, tb = np_batch(14, 2, 16, cfg.d_model, cfg.vocab)
    step = steps.build_cell(cfg, configs.SMOKE_SHAPE).step_fn

    def run():
        params = lm_params_from_arrays(arrays, cfg=cfg, device="cpu")
        return step(params, steps.make_optimizer(cfg).init(params), tb)

    plain = run()
    before = MATMUL.allow_tf32, MATMUL.allow_bf16_reduced_precision_reduction
    MATMUL.allow_tf32 = MATMUL.allow_bf16_reduced_precision_reduction = True
    try:
        with FlagsAtProducts() as spy:
            flipped = run()
        assert (MATMUL.allow_tf32,
                MATMUL.allow_bf16_reduced_precision_reduction) == (True, True)
    finally:
        (MATMUL.allow_tf32,
         MATMUL.allow_bf16_reduced_precision_reduction) = before
    n_layers, per_layer_fwd = cfg.n_layers, 6   # q, k, v, scores, P·V, o
    assert len(spy.seen) > 3 * n_layers * per_layer_fwd
    assert set(spy.seen) == {(False, False)}
    for a, b in zip(common.leaves(list(plain)), common.leaves(list(flipped))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the cells counted on meta tensors at full width
# ---------------------------------------------------------------------------

def matmul_flops(cfg, b: int, s: int, train: bool) -> int:
    """Hand count of a cell's products. Forward: per layer q, k, v, o,
    the scores and ``P·V``, the MLP; the unembedding. Train: the forward,
    the backward (two products a product: the input's gradient and the
    weight's; every layer's input needs one, since the norms' weights
    take gradients), and with ``"full"`` remat each layer's recompute,
    which stops before ``w_down`` (``torch.utils.checkpoint``'s early
    stop: the backward pass saved that product's inputs, not its
    output)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    f, T = cfg.d_ff, b * s
    down = 2 * T * f * d
    layer = (2 * T * d * (h + 2 * kv) * hd + 2 * T * h * hd * d
             + 2 * 2 * b * s * s * h * hd + 2 * T * d * f + down)
    fwd = cfg.n_layers * layer + 2 * T * d * cfg.vocab
    if not train:
        return fwd
    return 3 * fwd + (cfg.n_layers * (layer - down)
                      if cfg.remat == "full" else 0)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_full_width_flops_are_the_hand_count(shape):
    cfg = configs.get_config(ARCH)
    sh = configs.SHAPES[shape]
    cell = steps.build_cell(cfg, sh)
    with FlopCounterMode(display=False) as fc:
        out = cell.step_fn(*cell.abstract_args)
    assert fc.get_total_flops() == matmul_flops(
        cfg, sh.global_batch, sh.seq_len, sh.kind == "train")
    if sh.kind == "prefill":
        assert tuple(out.shape) == (sh.global_batch, sh.seq_len, cfg.vocab)
        assert out.dtype == torch.bfloat16 and out.device.type == "meta"
    else:
        assert out[2].shape == () and out[1].step.device.type == "meta"


def test_smoke_flops_with_and_without_remat():
    for remat in ("none", "full"):
        cfg = configs.get_smoke(ARCH).replace(remat=remat)
        sh = configs.SMOKE_SHAPE
        cell = steps.build_cell(cfg, sh)
        with FlopCounterMode(display=False) as fc:
            cell.step_fn(*cell.abstract_args)
        assert fc.get_total_flops() == matmul_flops(
            cfg, sh.global_batch, sh.seq_len, True)
