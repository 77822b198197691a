"""PyTorch port, the detector's backbone: ``repro_torch.models`` and
``repro_torch.configs`` against ``repro.models`` and ``repro.configs`` on
the same numpy inputs (``np.random.default_rng``) or on the reference's own
``init_detector_params`` carried across by ``detector_params_from_arrays``.

Tolerances, relative to the largest magnitude of the reference's output:
float32 ``F32_RTOL`` (the two packages sum in another order);
bf16 ``BF16_RTOL`` for one rounding step (the norms, RoPE: one bf16 ulp is
2^-8), and ``BF16_NET_RTOL`` for a network, where bf16 products rounded
in another order feed attention's near-one-hot softmax."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch import configs
from repro_torch.convert import detector_params_from_arrays
from repro_torch.models import attention, common, lm, mlp

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

F32_RTOL = 1e-5
BF16_RTOL = 1e-2
BF16_NET_RTOL = 5e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rng_normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def to_np(x) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, rtol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale, rtol)


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def rtol_of(dtype: str) -> float:
    return F32_RTOL if dtype == "float32" else BF16_RTOL


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_configs_equal_the_reference(which, arch):
    got = getattr(configs, which)(arch)
    want = getattr(jconfigs, which)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim


def test_ported_archs_are_the_reference_order():
    assert configs.ARCH_IDS == [a for a in jconfigs.ARCH_IDS
                                if a in configs.ARCH_IDS]


def test_the_architectures_are_the_reference_s():
    """Every architecture of the reference, in its order: none is
    refused."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        lm.Model(configs.get_config(arch))


def test_an_unknown_arch_id_raises():
    with pytest.raises(ValueError, match="no config"):
        configs.get_config("no-such-arch")
    with pytest.raises(ModuleNotFoundError):
        jconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("family", ["rnn", "transformer"])
def test_model_refuses_an_unknown_family(family):
    """A plain ``ValueError``, as the reference's ``spec`` raises."""
    cfg = configs.get_smoke("olmo-1b").replace(family=family)
    with pytest.raises(ValueError, match=re.escape(repr(family))):
        lm.Model(cfg)
    with pytest.raises(ValueError, match=family):
        jlm.build(jconfigs.get_smoke("olmo-1b").replace(
            family=family)).spec()


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_model_takes_the_moe_family(arch):
    """The mixture of experts: its layers hold a ``moe`` subtree (router
    and the stacked experts) in place of the MLP; a dense config given
    experts takes it too, as the reference's layer does."""
    cfg = configs.get_smoke(arch)
    spec = lm.Model(cfg).spec()["layers"]
    assert "mlp" not in spec and sorted(spec["moe"]) == [
        "router", "w_down", "w_gate", "w_up"]
    assert spec["moe"]["w_gate"].shape == (cfg.n_layers, cfg.n_experts,
                                           cfg.d_model, cfg.d_ff)
    olmo = lm.Model(configs.get_smoke("olmo-1b").replace(n_experts=8,
                                                          top_k=2))
    assert "moe" in olmo.spec()["layers"]


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(dtype, affine):
    x = rng_normal(0, (3, 5, 48), 2.0) + 0.7
    w, b = rng_normal(1, (48,)) + 1.0, rng_normal(2, (48,))
    jx, tx = both(x, dtype)
    if affine:
        want = jcommon.layer_norm(jx, jnp.asarray(w), jnp.asarray(b))
        got = common.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b))
    else:
        want = jcommon.layer_norm(jx)
        got = common.layer_norm(tx)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, want, rtol_of(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x = rng_normal(3, (2, 7, 32), 3.0)
    w = rng_normal(4, (32,)) + 1.0
    jx, tx = both(x, dtype)
    got = common.rms_norm(tx, torch.from_numpy(w))
    assert_close(got, jcommon.rms_norm(jx, jnp.asarray(w)), rtol_of(dtype))
    assert_close(common.rms_norm(tx, None), jcommon.rms_norm(jx, None),
                 rtol_of(dtype))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm",
                                  "nonparametric_ln"])
def test_apply_norm_and_norm_spec(kind):
    x = rng_normal(5, (2, 3, 16))
    spec = common.norm_spec(16, kind)
    jspec = jcommon.norm_spec(16, kind)
    assert {k: tuple(p.shape) for k, p in spec.items()} == \
        {k: tuple(p.shape) for k, p in jspec.items()}
    params = {k: torch.from_numpy(rng_normal(6 + i, (16,)))
              for i, k in enumerate(sorted(spec))} or None
    jparams = ({k: jnp.asarray(v.numpy()) for k, v in params.items()}
               if params else None)
    assert_close(common.apply_norm(torch.from_numpy(x), params, kind),
                 jcommon.apply_norm(jnp.asarray(x), jparams, kind), F32_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    x = rng_normal(7, (2, 9, 3, 16))
    pos = np.arange(9) + 5
    jx, tx = both(x, dtype)
    got = common.apply_rope(tx, torch.from_numpy(pos), 500.0)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, jcommon.apply_rope(jx, jnp.asarray(pos), 500.0),
                 rtol_of(dtype))


# ---------------------------------------------------------------------------
# attention and the MLP
# ---------------------------------------------------------------------------

def attn_inputs(cfg, seed):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d)}
    params = {k: rng_normal(seed + i, s, 0.2)
              for i, (k, s) in enumerate(sorted(shapes.items()))}
    x = rng_normal(seed + 9, (2, 11, d))
    return params, x


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_heads,q_chunk", [(4, 1024), (2, 4)])
def test_attention_full(causal, kv_heads, q_chunk):
    """Bidirectional and causal, MHA and GQA, one query block and the
    chunked loop (a ragged last block)."""
    cfg = attention.AttnConfig(d_model=32, n_heads=4, kv_heads=kv_heads,
                               head_dim=8, causal=causal, q_chunk=q_chunk)
    jcfg = jattn.AttnConfig(*cfg)
    params, x = attn_inputs(cfg, 10)
    assert {k: tuple(p.shape) for k, p in attention.spec(cfg).items()} == \
        {k: tuple(p.shape) for k, p in jattn.spec(jcfg).items()}
    want = jattn.full({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x), jcfg)
    got = attention.full({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x), cfg)
    assert_close(got, want, F32_RTOL)


def test_attention_bf16():
    cfg = attention.AttnConfig(d_model=32, n_heads=4, kv_heads=4,
                               head_dim=8, causal=False)
    params, x = attn_inputs(cfg, 20)
    jx, tx = both(x, "bfloat16")
    want = jattn.full({k: jnp.asarray(v) for k, v in params.items()}, jx,
                      jattn.AttnConfig(*cfg))
    got = attention.full({k: torch.from_numpy(v) for k, v in params.items()},
                         tx, cfg)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, BF16_NET_RTOL)


@pytest.mark.parametrize("activation,gated", [("gelu", False),
                                              ("silu", True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(activation, gated, dtype):
    cfg = mlp.MLPConfig(d_model=24, d_ff=40, activation=activation,
                        gated=gated)
    jcfg = jmlp.MLPConfig(*cfg)
    spec = mlp.spec(cfg)
    assert {k: tuple(p.shape) for k, p in spec.items()} == \
        {k: tuple(p.shape) for k, p in jmlp.spec(jcfg).items()}
    params = {k: rng_normal(30 + i, p.shape, 0.3)
              for i, (k, p) in enumerate(sorted(spec.items()))}
    x = rng_normal(39, (2, 5, 24), 2.0)
    jx, tx = both(x, dtype)
    want = jmlp.apply({k: jnp.asarray(v) for k, v in params.items()}, jx,
                      jcfg)
    got = mlp.apply({k: torch.from_numpy(v) for k, v in params.items()}, tx,
                    cfg)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, want, F32_RTOL if dtype == "float32"
                 else BF16_NET_RTOL)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the erf form
    differs by more than the float32 tolerance."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = mlp._act(torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


# ---------------------------------------------------------------------------
# the encoder stack
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_params():
    cfg = jconfigs.get_smoke("hubert-xlarge")
    tree = jsteps.init_detector_params(jax.random.PRNGKey(3), cfg,
                                       frame_hw=(16, 16), patch=8)
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward(smoke_params, dtype):
    """``Model.forward`` of the hubert-xlarge smoke config on the
    reference's parameters: float32 within F32_RTOL, bf16 within
    BF16_NET_RTOL."""
    jcfg = jconfigs.get_smoke("hubert-xlarge").replace(compute_dtype=dtype)
    cfg = configs.get_smoke("hubert-xlarge").replace(compute_dtype=dtype)
    tree = detector_params_from_arrays(
        jax.tree.map(np.asarray, smoke_params), device="cpu")
    emb = rng_normal(40, (2, 12, cfg.d_model))
    jmodel = jlm.build(jcfg)
    want, _ = jmodel.forward(smoke_params["backbone"], jlm.Batch(
        tokens=None, labels=jnp.zeros((2, 12), jnp.int32),
        embeds=jnp.asarray(emb)))
    got = lm.Model(cfg).forward(tree["backbone"], lm.Batch(
        None, None, torch.from_numpy(emb)))
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, want, F32_RTOL if dtype == "float32"
                 else BF16_NET_RTOL)


def test_model_forward_with_listed_layers(smoke_params):
    """``scan_layers=False`` keeps one tree per layer; same logits."""
    cfg = configs.get_smoke("hubert-xlarge")
    tree = detector_params_from_arrays(
        jax.tree.map(np.asarray, smoke_params), device="cpu")["backbone"]
    listed = dict(tree, layers=[lm.layer_params(tree["layers"], i)
                                for i in range(cfg.n_layers)])
    emb = lm.Batch(None, None,
                   torch.from_numpy(rng_normal(41, (1, 6, cfg.d_model))))
    stacked = lm.Model(cfg).forward(tree, emb)
    assert torch.equal(lm.Model(cfg.replace(scan_layers=False)).forward(
        listed, emb), stacked)


def spec_shapes(spec, is_p):
    out = {}

    def walk(node, path):
        if is_p(node):
            out[path] = (tuple(node.shape), node.init, node.scale)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        else:
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
    walk(spec, "")
    return out


@pytest.mark.parametrize("scan_layers", [True, False])
def test_spec_matches_the_reference(scan_layers):
    cfg = configs.get_smoke("hubert-xlarge").replace(scan_layers=scan_layers)
    jcfg = jconfigs.get_smoke("hubert-xlarge").replace(
        scan_layers=scan_layers)
    got = spec_shapes(lm.Model(cfg).spec(),
                      lambda x: isinstance(x, common.P))
    want = spec_shapes(jlm.build(jcfg).spec(),
                       lambda x: isinstance(x, jcommon.P))
    assert got == want
    assert common.count_params(lm.Model(cfg).spec()) == \
        jcommon.spec_param_count(jlm.build(jcfg).spec())


def test_full_width_param_count():
    """hubert-xlarge's backbone at full width: 944,611,840 parameters."""
    cfg = configs.get_config("hubert-xlarge")
    assert common.count_params(lm.Model(cfg).spec()) == 944_611_840 == \
        jcommon.spec_param_count(jlm.build(
            jconfigs.get_config("hubert-xlarge")).spec())


def test_init_params_shapes_and_scales():
    """Each leaf's shape, dtype and spread against the reference's init of
    the same spec: zeros and ones exactly, normal leaves with the
    reference's scale (``fan_in = shape[-2]``: the head count for the 3-D
    attention weights) within 10% over a 4x4-headed spec wide enough to
    count."""
    cfg = configs.get_smoke("hubert-xlarge").replace(d_model=128, d_ff=256)
    jcfg = jconfigs.get_smoke("hubert-xlarge").replace(d_model=128,
                                                       d_ff=256)
    spec = lm.Model(cfg).spec()
    got = lm.Model(cfg).init(torch.Generator().manual_seed(0))
    want = jlm.build(jcfg).init(jax.random.PRNGKey(0))
    decl = spec_shapes(spec, lambda x: isinstance(x, common.P))
    g_leaves, w_leaves = common.leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves) == len(decl)
    for (path, (shape, init, scale)), g, w in zip(decl.items(), g_leaves,
                                                  w_leaves):
        assert tuple(g.shape) == shape == tuple(w.shape), path
        assert g.dtype == torch.float32, path
        if init == "zeros":
            assert not g.any(), path
        elif init == "ones":
            assert bool((g == 1).all()), path
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            want_std = scale if scale is not None else fan_in ** -0.5
            assert float(g.std()) == pytest.approx(want_std, rel=0.1), path
            assert float(np.asarray(w).std()) == pytest.approx(want_std,
                                                               rel=0.1)


def test_unembed():
    x = rng_normal(50, (2, 3, 16))
    k = rng_normal(51, (16, 10))
    got = common.unembed({"kernel": torch.from_numpy(k)},
                         torch.from_numpy(x), torch.float32)
    want = jcommon.unembed({"kernel": jnp.asarray(k)}, jnp.asarray(x),
                           jnp.float32)
    assert_close(got, want, F32_RTOL)
    assert common.unembed_spec(10, 16)["kernel"].shape == \
        jcommon.unembed_spec(10, 16)["kernel"].shape
