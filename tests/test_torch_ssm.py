"""PyTorch port, the Mamba-2 (SSD) mixer: ``repro_torch.models.ssm``
against ``repro.models.ssm`` on the same numpy inputs.

``spec``, ``state_spec``, ``state_axes`` and ``init_state`` against the
reference's; ``_segsum`` (the cumsum difference, ``-inf`` above the
diagonal); ``ssd_chunked`` at one and two groups (``repeat_interleave``:
head ``i`` reads group ``i // (h // g)``) over several chunks and one,
``y`` and the final state within ``F32_RTOL`` of their largest |entry|,
and a sequence the chunk does not divide refused (``ValueError``; the
reference asserts); ``apply`` in float32 (``F32_RTOL``) and bf16
(``BF16_RTOL``), its gradients against ``jax.vjp`` (``GRAD_RTOL`` of each
leaf's largest |entry|), a ragged sequence refused; ``decode_step`` from
a random state in float32, its output within ``F32_RTOL``, the SSM state
within ``F32_RTOL`` and the bf16 convolution buffer within one bf16 ulp
(and a float32 buffer, ``conv_dtype``); the decode step run over a
sequence against ``apply`` on it within the port (the recurrence against
the chunked form); a meta pass; the step's source free of host syncs.

The mixer's weights are drawn at ``WEIGHT_STD``, its norm scale ``1 +
0.1 N`` and its ``zeros`` leaves (``A_log``, ``dt_bias``, ``conv_b``)
``0.1 N``, as in ``tests/test_torch_lm_dense.py``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import within_one_bf16_ulp
from repro.models import ssm as jssm
from repro_torch.models import common, ssm

jax.config.update("jax_platform_name", "cpu")

F32_RTOL = 1e-5
GRAD_RTOL = 1e-5
BF16_RTOL = 5e-2
WEIGHT_STD = 0.2
#: the smoke zamba2's mixer: d_model 64, 8 heads of 16, state 8, chunk 16
CFG = dict(d_model=64, d_inner=128, n_heads=8, head_dim=16, d_state=8,
           chunk=16)


def cfgs(**kw):
    c = dict(CFG, **kw)
    return ssm.SSMConfig(**c), jssm.SSMConfig(**c)


def np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def one(p):
        x = rng.standard_normal(p.shape).astype(np.float32)
        if p.init == "ones":
            return 1 + 0.1 * x
        if p.init == "zeros":
            return 0.1 * x
        return WEIGHT_STD * x
    return common.tree_map(one, ssm.spec(cfg),
                           lambda x: isinstance(x, common.P))


def both(arrays):
    return (common.tree_map(torch.from_numpy, arrays),
            jax.tree.map(jnp.asarray, arrays))


def rel(got, want) -> float:
    got = np.asarray(got.detach().to(torch.float32) if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# specs and states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_spec_and_state_equal_the_reference(groups):
    cfg, jcfg = cfgs(n_groups=groups)
    got, want = ssm.spec(cfg), jssm.spec(jcfg)
    g = common.leaves(got)
    w = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "axes"))
    assert [(tuple(a.shape), tuple(a.axes), a.init) for a in g] == \
        [(tuple(b.shape), tuple(b.axes), b.init) for b in w]
    for a, b in zip(ssm.state_spec(cfg, 3), jssm.state_spec(jcfg, 3)):
        assert a.device.type == "meta" and tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    assert tuple(ssm.state_axes()) == tuple(jssm.state_axes())
    st = ssm.init_state(cfg, 2, torch.float32, device="cpu")
    jst = jssm.init_state(jcfg, 2, jnp.float32)
    for a, b in zip(st, jst):
        assert a.dtype == torch.float32 and not a.any()
        assert tuple(a.shape) == b.shape


def test_segsum_equals_the_reference():
    x = np.random.default_rng(0).standard_normal((3, 2, 16)).astype(
        np.float32)
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * np.abs(
        want[fin]).max()


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

def scan_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("groups,s,chunk", [(1, 64, 16), (2, 64, 16),
                                            (2, 48, 48), (1, 40, 8)])
def test_ssd_chunked_equals_the_reference(groups, s, chunk):
    """Several chunks and one; at two groups the heads 0-1 read group 0
    and 2-3 group 1, as ``jnp.repeat`` gives them."""
    inp = scan_inputs(1, 2, s, 4, 8, groups, 5)
    y, st = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, inp), chunk)
    ty, tst = ssm.ssd_chunked(*map(torch.from_numpy, inp), chunk)
    assert ty.dtype == torch.float32 and tst.shape == st.shape
    assert rel(ty, y) <= F32_RTOL
    assert rel(tst, st) <= F32_RTOL


def test_ssd_chunked_reads_each_head_s_group():
    """Moving group 1's B and C moves heads 2 and 3 alone."""
    inp = list(scan_inputs(2, 1, 32, 4, 8, 2, 5))
    y0, _ = ssm.ssd_chunked(*map(torch.from_numpy, inp), 16)
    inp[3] = inp[3].copy()
    inp[3][:, :, 1] += 1.0
    y1, _ = ssm.ssd_chunked(*map(torch.from_numpy, inp), 16)
    moved = (y1 - y0).abs().amax(dim=(0, 1, 3))
    assert moved[:2].max() == 0 and moved[2:].min() > 0


def test_ssd_chunked_refuses_a_ragged_sequence():
    inp = scan_inputs(3, 1, 24, 4, 8, 1, 5)
    with pytest.raises(ValueError, match="chunk"):
        ssm.ssd_chunked(*map(torch.from_numpy, inp), 16)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, inp), 16)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_equals_the_reference(dtype):
    cfg, jcfg = cfgs()
    params, jparams = both(np_params(cfg, 4))
    x = np.random.default_rng(5).standard_normal((2, 32, 64)).astype(
        np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax.jit(jssm.apply, static_argnums=2)(jparams, jnp.asarray(x, jd),
                                                 jcfg)
    got = ssm.apply(params, torch.from_numpy(x).to(td), cfg)
    assert got.dtype == td and tuple(got.shape) == (2, 32, 64)
    assert rel(got, want) <= (F32_RTOL if dtype == "float32" else BF16_RTOL)


def test_apply_gradients_equal_the_reference():
    cfg, jcfg = cfgs()
    arrays = np_params(cfg, 6)
    x = np.random.default_rng(7).standard_normal((2, 32, 64)).astype(
        np.float32)
    ct = np.random.default_rng(8).standard_normal((2, 32, 64)).astype(
        np.float32)

    @jax.jit
    def ref_vjp(p, xx, c):
        return jax.vjp(lambda a, b: jssm.apply(a, b, jcfg), p, xx)[1](c)
    jg_p, jg_x = ref_vjp(jax.tree.map(jnp.asarray, arrays), jnp.asarray(x),
                         jnp.asarray(ct))
    params = common.tree_map(lambda a: torch.from_numpy(a).requires_grad_(),
                             arrays)
    tx = torch.from_numpy(x).requires_grad_()
    out = ssm.apply(params, tx, cfg)
    grads = torch.autograd.grad(out, [*common.leaves(params), tx],
                                torch.from_numpy(ct))
    want = [*jax.tree.leaves(jg_p), jg_x]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert rel(g, w) <= GRAD_RTOL


def test_apply_refuses_a_ragged_sequence():
    """``s`` no multiple of ``min(chunk, s)``: the reference asserts."""
    cfg, jcfg = cfgs()
    params, jparams = both(np_params(cfg, 9))
    x = np.zeros((1, 24, 64), np.float32)
    with pytest.raises(ValueError, match="chunk"):
        ssm.apply(params, torch.from_numpy(x), cfg)
    with pytest.raises(AssertionError):
        jssm.apply(jparams, jnp.asarray(x), jcfg)


def test_apply_on_meta_tensors():
    cfg, _ = cfgs()
    params = common.abstract_params(ssm.spec(cfg))
    out = ssm.apply(params, torch.empty((2, 32, 64), device="meta"), cfg)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 32, 64)


# ---------------------------------------------------------------------------
# the recurrent step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conv", ["bfloat16", "float32"])
def test_decode_step_equals_the_reference(conv):
    """Three steps from a random state (the buffer in ``conv``): each
    output within F32_RTOL, then the SSM state within F32_RTOL and the
    buffer within one bf16 ulp (bitwise where float32)."""
    cfg, jcfg = cfgs()
    params, jparams = both(np_params(cfg, 10))
    rng = np.random.default_rng(11)
    spec = ssm.state_spec(cfg, 2)
    s0 = rng.standard_normal(tuple(spec.ssm.shape)).astype(np.float32)
    c0 = rng.standard_normal(tuple(spec.conv.shape)).astype(np.float32)
    jd, td = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
              "float32": (jnp.float32, torch.float32)}[conv]
    jst = jssm.SSMState(jnp.asarray(s0), jnp.asarray(c0, jd))
    # copies: the step writes the state in place, and the reference's
    # arrays may share the numpy buffers
    st = ssm.SSMState(torch.from_numpy(s0.copy()),
                      torch.from_numpy(c0.copy()).to(td))
    xs = rng.standard_normal((3, 2, 1, 64)).astype(np.float32)
    jstep = jax.jit(jssm.decode_step, static_argnums=3)
    for x in xs:
        want, jst = jstep(jparams, jnp.asarray(x), jst, jcfg)
        got = ssm.decode_step(params, torch.from_numpy(x), st, cfg)
        assert tuple(got.shape) == (2, 1, 64)
        assert rel(got, want) <= F32_RTOL
    assert st.conv.dtype == td
    assert rel(st.ssm, jst.ssm) <= F32_RTOL
    assert within_one_bf16_ulp(st.conv, np.asarray(jst.conv, np.float32))


def test_decode_steps_are_the_chunked_scan():
    """The step over a sequence (a float32 buffer from zeros) against
    ``apply`` on the whole sequence, both the port's: the recurrence
    against the chunked form, within F32_RTOL."""
    cfg, _ = cfgs()
    params, _ = both(np_params(cfg, 12))
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 32, 64)).astype(np.float32))
    full = ssm.apply(params, x, cfg)
    st = ssm.init_state(cfg, 2, torch.float32, device="cpu")
    steps = torch.cat([ssm.decode_step(params, x[:, t:t + 1], st, cfg)
                       for t in range(32)], dim=1)
    assert rel(steps, full.numpy()) <= F32_RTOL


def test_decode_step_makes_no_host_sync():
    for fn in (ssm.decode_step, ssm._project, ssm._part, ssm._gated_norm,
               ssm._heads_cols, ssm._head_params, ssm._out):
        src = inspect.getsource(fn)
        for bad in (".item()", ".cpu()", ".tolist()", ".numpy()",
                    "float(", "bool("):
            assert bad not in src, (fn.__name__, bad)
