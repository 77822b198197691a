"""PyTorch port, the xLSTM blocks: ``repro_torch.models.xlstm`` against
``repro.models.xlstm`` on the same numpy inputs.

The specs, states and axes against the reference's; ``mlstm_parallel``
at one, two and four chunks, its output and final ``(C, n, m)`` carry
within ``F32_RTOL`` of their largest |entry|, a run of ``mlstm_step``
calls against it within ``STEP_RTOL``, a ragged sequence refused;
``mlstm_block`` and ``slstm_block`` (from zeros and from a given state)
in float32 (``F32_RTOL``) and bf16 (``BF16_RTOL``), their gradients
against ``jax.vjp`` (``GRAD_RTOL`` of each leaf's largest |entry| in
float32, ``BF16_RTOL`` in bf16; none NaN through the masked entries of
the within-chunk form); ``mlstm_block_step`` and ``slstm_block_step``
over three tokens from a random state, the output and the states within
``F32_RTOL`` (the bf16 convolution buffer within one bf16 ulp), the
state written in place; the custom op ``repro_torch::slstm_scan``: its
forward and gradients bitwise the plain loop under autograd (with and
without ``torch.utils.checkpoint``), ``FlopCounterMode``'s count of a
forward and backward through it on the CPU equal to its count on meta
tensors and to the hand count, 32,768 steps with backward on meta
tensors in under ``META_S`` seconds; a meta pass of both blocks; the
decode steps' source free of host syncs.

The blocks' weights are drawn at ``WEIGHT_STD``, norm scales ``1 + 0.1
N``, the ``zeros`` leaves ``0.1 N`` and ``b_f`` ``1 + 0.1 N``.
"""

import inspect
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from torch.utils.flop_counter import FlopCounterMode

from _torch_parity import within_one_bf16_ulp
from repro.models import xlstm as jx
from repro_torch.models import common, xlstm

jax.config.update("jax_platform_name", "cpu")

F32_RTOL = 1e-5
STEP_RTOL = 1e-4
GRAD_RTOL = 1e-4
BF16_RTOL = 5e-2
WEIGHT_STD = 0.2
META_S = 10.0
#: the smoke xlstm-350m's blocks: d_model 64, 2 heads, d_inner 128,
#: chunk 16
CFG = dict(d_model=64, n_heads=2, chunk=16)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def cfgs(**kw):
    c = dict(CFG, **kw)
    return xlstm.XLSTMConfig(**c), jx.XLSTMConfig(**c)


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


def rel(got, want) -> float:
    got = np.asarray(got.detach().to(torch.float32) if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def spec_rows(spec):
    return [(tuple(p.shape), tuple(p.axes), p.init, p.scale)
            for p in common.leaves(spec)]


# ---------------------------------------------------------------------------
# specs and states
# ---------------------------------------------------------------------------

def test_specs_and_states_equal_the_reference():
    cfg, jcfg = cfgs()
    for got, want in ((xlstm.mlstm_spec(cfg), jx.mlstm_spec(jcfg)),
                      (xlstm.slstm_spec(cfg), jx.slstm_spec(jcfg))):
        w = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "axes"))
        assert spec_rows(got) == [(tuple(p.shape), tuple(p.axes), p.init,
                                   p.scale) for p in w]
    for conv in (torch.bfloat16, torch.float32):
        jconv = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
        for a, b in zip(xlstm.mlstm_state_spec(cfg, 3, conv),
                        jx.mlstm_state_spec(jcfg, 3, jconv[conv])):
            assert a.device.type == "meta" and tuple(a.shape) == b.shape
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    for a, b in zip(xlstm.slstm_state_spec(cfg, 3),
                    jx.slstm_state_spec(jcfg, 3)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    assert tuple(xlstm.mlstm_state_axes()) == tuple(jx.mlstm_state_axes())
    assert tuple(xlstm.slstm_state_axes()) == tuple(jx.slstm_state_axes())
    for st, jst in ((xlstm.init_mlstm_state(cfg, 2, device="cpu"),
                     jx.init_mlstm_state(jcfg, 2)),
                    (xlstm.init_slstm_state(cfg, 2, device="cpu"),
                     jx.init_slstm_state(jcfg, 2))):
        for a, b in zip(st, jst):
            assert not a.any() and tuple(a.shape) == b.shape
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


# ---------------------------------------------------------------------------
# the mLSTM cell
# ---------------------------------------------------------------------------

def cell_inputs(seed, b, s, h, dh):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((b, s, h)).astype(np.float32)
    fg = (2.0 + rng.standard_normal((b, s, h))).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("s,chunk", [(16, 16), (32, 16), (64, 16)])
def test_mlstm_parallel_equals_the_reference(s, chunk):
    """One, two and four chunks: the output and the final carry."""
    inp = cell_inputs(1, 2, s, 2, 8)
    hs, carry = jax.jit(jx.mlstm_parallel, static_argnums=5)(
        *map(jnp.asarray, inp), chunk)
    ths, tcarry = xlstm.mlstm_parallel(*map(torch.from_numpy, inp), chunk)
    assert ths.dtype == torch.float32
    assert rel(ths, hs) <= F32_RTOL
    for a, b in zip(tcarry, carry, strict=True):
        assert rel(a, b) <= F32_RTOL


def test_mlstm_steps_are_the_chunkwise_form():
    """``mlstm_step`` token by token from a zero carry against
    ``mlstm_parallel`` over four chunks: every output and the final
    carry within STEP_RTOL."""
    inp = [torch.from_numpy(a) for a in cell_inputs(2, 2, 64, 2, 8)]
    hs, carry = xlstm.mlstm_parallel(*inp, 16)
    st = (torch.zeros(2, 2, 8, 8), torch.zeros(2, 2, 8), torch.zeros(2, 2))
    outs = []
    for t in range(64):
        out, st = xlstm.mlstm_step(*(a[:, t] for a in inp), st)
        outs.append(out)
    assert rel(torch.stack(outs, 1), hs.numpy()) <= STEP_RTOL
    for a, b in zip(st, carry):
        assert rel(a, b.numpy()) <= STEP_RTOL


def test_mlstm_step_equals_the_reference():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 8)).astype(np.float32)
               for _ in range(3))
    ig, fg = (rng.standard_normal((2, 2)).astype(np.float32)
              for _ in range(2))
    carry = (rng.standard_normal((2, 2, 8, 8)).astype(np.float32),
             np.abs(rng.standard_normal((2, 2, 8))).astype(np.float32),
             rng.standard_normal((2, 2)).astype(np.float32))
    want, jc = jx.mlstm_step(*map(jnp.asarray, (q, k, v, ig, fg)),
                             tuple(map(jnp.asarray, carry)))
    tc = tuple(torch.from_numpy(a) for a in carry)
    got, c = xlstm.mlstm_step(*map(torch.from_numpy, (q, k, v, ig, fg)), tc)
    assert rel(got, want) <= F32_RTOL
    for a, b in zip(c, jc):
        assert rel(a, b) <= F32_RTOL
    # the carry handed in is left as it was
    np.testing.assert_array_equal(tc[0].numpy(), carry[0])


def test_mlstm_parallel_refuses_a_ragged_sequence():
    inp = cell_inputs(4, 1, 24, 2, 8)
    with pytest.raises(ValueError, match="chunk"):
        xlstm.mlstm_parallel(*map(torch.from_numpy, inp), 16)
    with pytest.raises(AssertionError):
        jx.mlstm_parallel(*map(jnp.asarray, inp), 16)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def block_case(kind, seed, dtype, s=32, state=False):
    """Weights, an input and (``state``) a random sLSTM state for both
    packages, and the two block functions."""
    cfg, jcfg = cfgs()
    spec = (xlstm.mlstm_spec if kind == "mlstm" else xlstm.slstm_spec)(cfg)
    arrays = np_params(spec, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    st = None
    if state:
        st = [rng.standard_normal(tuple(t.shape)).astype(np.float32)
              for t in xlstm.slstm_state_spec(cfg, 2)]
        st[1] = np.abs(st[1]) + 0.5
    jd, td = DTYPES[dtype]
    if kind == "mlstm":
        def jfn(p, xx):
            return jx.mlstm_block(p, xx, jcfg)

        def tfn(p, xx):
            return xlstm.mlstm_block(p, xx, cfg)
    else:
        def jfn(p, xx):
            js = None if st is None else jx.SLSTMState(*map(jnp.asarray, st))
            return jx.slstm_block(p, xx, jcfg, js)[0]

        def tfn(p, xx):
            ts = None if st is None else xlstm.SLSTMState(
                *map(torch.from_numpy, st))
            return xlstm.slstm_block(p, xx, cfg, ts)[0]
    return arrays, x, st, jd, td, jfn, tfn


BLOCKS = [("mlstm", False), ("slstm", False), ("slstm", True)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,state", BLOCKS)
def test_block_equals_the_reference(kind, state, dtype):
    arrays, x, _, jd, td, jfn, tfn = block_case(kind, 5, dtype, state=state)
    want = jax.jit(jfn)(jax.tree.map(lambda a: jnp.asarray(a, jd), arrays),
                        jnp.asarray(x, jd))
    got = tfn(common.tree_map(lambda a: torch.from_numpy(a).to(td), arrays),
              torch.from_numpy(x).to(td))
    assert got.dtype == td and tuple(got.shape) == x.shape
    assert rel(got, want) <= (F32_RTOL if dtype == "float32"
                              else BF16_RTOL)


def test_slstm_block_returns_the_final_state():
    cfg, jcfg = cfgs()
    arrays, x, st, *_ = block_case("slstm", 6, "float32", state=True)
    _, want = jax.jit(lambda p, xx, s0: jx.slstm_block(p, xx, jcfg, s0))(
        jax.tree.map(jnp.asarray, arrays), jnp.asarray(x),
        jx.SLSTMState(*map(jnp.asarray, st)))
    _, got = xlstm.slstm_block(common.tree_map(torch.from_numpy, arrays),
                               torch.from_numpy(x), cfg,
                               xlstm.SLSTMState(*map(torch.from_numpy, st)))
    for a, b in zip(got, want, strict=True):
        assert a.dtype == torch.float32 and rel(a, b) <= F32_RTOL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,state", BLOCKS)
def test_block_gradients_equal_the_reference(kind, state, dtype):
    """``jax.vjp`` against autograd at one cotangent, every weight leaf
    and the input; every gradient finite."""
    arrays, x, _, jd, td, jfn, tfn = block_case(kind, 7, dtype, state=state)
    ct = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def ref_vjp(p, xx, c):
        return jax.vjp(jfn, p, xx)[1](c)
    jg_p, jg_x = ref_vjp(jax.tree.map(lambda a: jnp.asarray(a, jd), arrays),
                         jnp.asarray(x, jd), jnp.asarray(ct, jd))
    params = common.tree_map(
        lambda a: torch.from_numpy(a).to(td).requires_grad_(), arrays)
    tx = torch.from_numpy(x).to(td).requires_grad_()
    grads = torch.autograd.grad(tfn(params, tx),
                                [*common.leaves(params), tx],
                                torch.from_numpy(ct).to(td))
    want = [*jax.tree.leaves(jg_p), jg_x]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        assert rel(g, w) <= (GRAD_RTOL if dtype == "float32"
                             else BF16_RTOL)


def np_mlstm_state(cfg, seed, conv):
    rng = np.random.default_rng(seed)
    spec = xlstm.mlstm_state_spec(cfg, 2, conv)
    C, n, m, c = (rng.standard_normal(tuple(t.shape)).astype(np.float32)
                  for t in spec)
    return C, np.abs(n) + 0.5, m, torch.from_numpy(c).to(conv).to(
        torch.float32).numpy()


@pytest.mark.parametrize("conv", ["bfloat16", "float32"])
def test_mlstm_block_step_equals_the_reference(conv):
    """Three tokens from a random state (the buffer in ``conv``): each
    output within F32_RTOL; then C, n and m within F32_RTOL and the
    buffer within one bf16 ulp (bitwise where float32); the state the
    same tensors, written in place."""
    cfg, jcfg = cfgs()
    arrays = np_params(xlstm.mlstm_spec(cfg), 9)
    jd, td = DTYPES[conv]
    C, n, m, c = np_mlstm_state(cfg, 10, td)
    jst = jx.MLSTMState(*map(jnp.asarray, (C, n, m)), jnp.asarray(c, jd))
    st = xlstm.MLSTMState(*(torch.from_numpy(a.copy()) for a in (C, n, m)),
                          torch.from_numpy(c.copy()).to(td))
    params = common.tree_map(torch.from_numpy, arrays)
    jparams = jax.tree.map(jnp.asarray, arrays)
    xs = np.random.default_rng(11).standard_normal((3, 2, 1, 64)).astype(
        np.float32)
    jstep = jax.jit(jx.mlstm_block_step, static_argnums=3)
    for x in xs:
        want, jst = jstep(jparams, jnp.asarray(x), jst, jcfg)
        got, out_st = xlstm.mlstm_block_step(params, torch.from_numpy(x), st,
                                             cfg)
        assert out_st is st and tuple(got.shape) == (2, 1, 64)
        assert rel(got, want) <= F32_RTOL
    for a, b in zip(st[:3], jst[:3]):
        assert rel(a, b) <= F32_RTOL
    assert st.conv.dtype == td
    assert within_one_bf16_ulp(st.conv, np.asarray(jst.conv, np.float32))


def test_slstm_block_step_equals_the_reference():
    cfg, jcfg = cfgs()
    arrays = np_params(xlstm.slstm_spec(cfg), 12)
    rng = np.random.default_rng(13)
    st0 = [rng.standard_normal(tuple(t.shape)).astype(np.float32)
           for t in xlstm.slstm_state_spec(cfg, 2)]
    st0[1] = np.abs(st0[1]) + 0.5
    jst = jx.SLSTMState(*map(jnp.asarray, st0))
    st = xlstm.SLSTMState(*(torch.from_numpy(a.copy()) for a in st0))
    params = common.tree_map(torch.from_numpy, arrays)
    jparams = jax.tree.map(jnp.asarray, arrays)
    jstep = jax.jit(jx.slstm_block_step, static_argnums=3)
    for x in rng.standard_normal((3, 2, 1, 64)).astype(np.float32):
        want, jst = jstep(jparams, jnp.asarray(x), jst, jcfg)
        got, out_st = xlstm.slstm_block_step(params, torch.from_numpy(x), st,
                                             cfg)
        assert out_st is st
        assert rel(got, want) <= F32_RTOL
    for a, b in zip(st, jst):
        assert rel(a, b) <= F32_RTOL


def test_blocks_on_meta_tensors():
    cfg, _ = cfgs()
    x = torch.empty((2, 32, 64), device="meta")
    for spec, fn in ((xlstm.mlstm_spec, xlstm.mlstm_block),
                     (xlstm.slstm_spec, lambda p, xx, c: xlstm.slstm_block(
                         p, xx, c)[0])):
        out = fn(common.abstract_params(spec(cfg)), x, cfg)
        assert out.device.type == "meta" and tuple(out.shape) == (2, 32, 64)


def test_decode_steps_make_no_host_sync():
    for fn in (xlstm.mlstm_block_step, xlstm.slstm_block_step,
               xlstm.slstm_block, xlstm._step_into, xlstm._mlstm_qkv_gates,
               xlstm._weight, xlstm._out, xlstm._rms_norm, xlstm.scan_loop,
               xlstm._slstm_cell):
        src = inspect.getsource(fn)
        for bad in (".item()", ".cpu()", ".tolist()", ".numpy()",
                    "float(", "bool("):
            assert bad not in src, (fn.__name__, bad)


# ---------------------------------------------------------------------------
# the sLSTM scan as one op
# ---------------------------------------------------------------------------

def scan_inputs(seed, b=2, s=12, h=2, dh=8, device="cpu", dtype=None):
    g = torch.Generator().manual_seed(seed)
    wx = torch.randn((b, s, 4, h, dh), generator=g)
    r = 0.3 * torch.randn((4, h, dh, dh), generator=g)
    st = [torch.randn((b, h, dh), generator=g) for _ in range(4)]
    st[1] = st[1].abs() + 0.5
    if dtype is not None:
        wx = wx.to(dtype)
    return [t.to(device) for t in (wx, r, *st)]


def scan_grads(fn, inputs, need, seed=20):
    """``fn``'s outputs and the gradients of the inputs flagged in
    ``need`` for one cotangent of every output."""
    ins = [t.clone().requires_grad_(ok) for t, ok in zip(inputs, need)]
    outs = fn(*ins)
    g = torch.Generator().manual_seed(seed)
    cts = [torch.randn(o.shape, generator=g) for o in outs]
    grads = torch.autograd.grad(outs, [t for t, ok in zip(ins, need) if ok],
                                cts)
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("checkpointed", [False, True])
@pytest.mark.parametrize("need", [(True, True, False, False, False, False),
                                  (True, True, True, True, True, True)])
def test_slstm_scan_is_bitwise_the_plain_loop(need, checkpointed):
    """The op's outputs and gradients against the plain loop's under
    autograd, bit for bit, the op also under a non-reentrant checkpoint."""
    inputs = scan_inputs(14)
    op = xlstm.slstm_scan
    if checkpointed:
        def op(*a):
            return torch.utils.checkpoint.checkpoint(
                xlstm.slstm_scan, *a, use_reentrant=False)
    got_o, got_g = scan_grads(op, inputs, need)
    want_o, want_g = scan_grads(xlstm.scan_loop, inputs, need)
    for a, b in zip([*got_o, *got_g], [*want_o, *want_g], strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_slstm_scan_bf16_input():
    """A bf16 ``wx``: float32 outputs, a bf16 gradient, both bitwise the
    plain loop's."""
    inputs = scan_inputs(15, dtype=torch.bfloat16)
    need = (True, True, False, False, False, False)
    got_o, got_g = scan_grads(xlstm.slstm_scan, inputs, need)
    want_o, want_g = scan_grads(xlstm.scan_loop, inputs, need)
    assert got_o[0].dtype == torch.float32 and got_g[0].dtype == \
        torch.bfloat16
    for a, b in zip([*got_o, *got_g], [*want_o, *want_g]):
        assert torch.equal(a, b)


def counted(inputs, need):
    ins = [t.clone().requires_grad_(ok) if t.device.type != "meta"
           else t.requires_grad_(ok) for t, ok in zip(inputs, need)]
    with FlopCounterMode(display=False) as fc:
        hids, *_ = xlstm.slstm_scan(*ins)
        torch.autograd.grad(hids.sum(), [t for t, ok in zip(ins, need)
                                         if ok])
    return fc.get_total_flops()


@pytest.mark.parametrize("need_h0", [False, True])
def test_slstm_scan_flops(need_h0):
    """The count of a forward and backward on the CPU (the op's formula
    for its forward, the recompute's and the backward's products as
    autograd runs them) equals the count on meta tensors (the two ops'
    formulas) and the hand count: ``s`` products forward, and backward
    ``s`` again, ``s`` for ``r`` and ``s - 1`` for the hidden state (``s``
    when the initial state takes a gradient)."""
    b, s, h, dh = 2, 12, 2, 8
    need = (True, True, False, False, need_h0, False)
    cpu = counted(scan_inputs(16, b, s, h, dh), need)
    meta = counted(scan_inputs(16, b, s, h, dh, device="meta"), need)
    step = 2 * b * 4 * h * dh * dh
    assert cpu == meta == (s + s + s + s - 1 + need_h0) * step


def test_slstm_scan_on_meta_is_fast():
    """32,768 steps of the op forward and backward on meta tensors, in
    under META_S seconds."""
    inputs = scan_inputs(17, 4, 32768, 4, 256, device="meta",
                         dtype=torch.bfloat16)
    t0 = time.perf_counter()
    n = counted(inputs, (True, True, False, False, False, False))
    assert time.perf_counter() - t0 < META_S
    assert n == (4 * 32768 - 1) * 2 * 4 * 4 * 4 * 256 * 256
