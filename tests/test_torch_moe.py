"""PyTorch port, the mixture of experts: ``repro_torch.models.mlp``'s
``moe_apply`` (and its ``route``) against ``repro.models.mlp.moe_apply``
on the CPU, on the same numpy inputs.

The cases: both MoE smoke configs' blocks (``qwen3-moe-235b-a22b``: 8
experts top-2; ``grok-1-314b``: 4 experts top-2, d_model 96), and on the
qwen3 block a starved capacity (``capacity_factor`` 0.5: slots drop),
the int8 dispatch payload and top-1 routing. Inputs ``N(0, 1)``, weights
at ``WEIGHT_STD``, from ``np.random.default_rng``.

Held, behind the precondition that every token's k + 1 largest router
probabilities lie ``ROUTING_MARGIN`` apart (in the reference's float32
routing; a flip would show as a failed precondition, not a pass): the
routing (expert ids, each slot's rank in its expert, ``keep``) equal to
the reference's arithmetic (``mlp.py``'s lines 110-130, the reference's
``bincount`` offsets among them), the gate weights within 1e-6; the
output within ``F32_RTOL`` of its largest |entry| in float32
(``BF16_RTOL`` in bf16), the auxiliary loss within ``AUX_RTOL``; the
input and weight gradients of ``sum(out * g) + aux`` within
``GRAD_RTOL`` of each leaf's largest |entry| against ``jax.vjp`` (at
top-1 the router's gradient of the output is mathematically zero, each
package's value its rounding residue: held below one float32 eps a token
of ``max|x_t| |dL/dgate_t|``; the auxiliary loss's gradient of the router
within ``GRAD_RTOL``); two runs bitwise, the gradients included, and
under ``torch.use_deterministic_algorithms(True)``; one pass on meta
tensors; no drops at ``capacity_factor = E / k``; the sources free of
host syncs and of ``bincount``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_mesh_worker import ROUTING_MARGIN, routing_margin
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch import configs
from repro_torch.models import lm, mlp

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(2)

WEIGHT_STD = 0.2
F32_RTOL = 1e-5
BF16_RTOL = 5e-2
AUX_RTOL = 1e-6
GRAD_RTOL = 1e-5
GATE_ATOL = 1e-6
B, S = 2, 24
#: (architecture, MoEConfig overrides)
CASES = {
    "qwen3": ("qwen3-moe-235b-a22b", {}),
    "grok": ("grok-1-314b", {}),
    "starved": ("qwen3-moe-235b-a22b", {"capacity_factor": 0.5}),
    "int8": ("qwen3-moe-235b-a22b", {"dispatch_int8": True}),
    "top1": ("qwen3-moe-235b-a22b", {"top_k": 1}),
}


def moe_cfgs(case):
    arch, kw = CASES[case]
    return (lm._moe_cfg(configs.get_smoke(arch))._replace(**kw),
            jlm._moe_cfg(jconfigs.get_smoke(arch))._replace(**kw))


def np_inputs(case, seed=0):
    cfg, _ = moe_cfgs(case)
    rng = np.random.default_rng(seed)
    params = {k: (WEIGHT_STD * rng.standard_normal(p.shape)).astype(
        np.float32) for k, p in sorted(mlp.moe_spec(cfg).items())}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return params, x, g


def jax_routing(params, x, jcfg):
    """The reference's routing (``repro/models/mlp.py:110-130``) on the
    same inputs: ``(probs, gate_w, gate_e, pos, keep)``."""
    n = x.shape[0] * x.shape[1]
    e, k = jcfg.n_experts, jcfg.top_k
    xf = jnp.asarray(x).reshape(n, -1)
    logits = xf.astype(jnp.float32) @ jnp.asarray(params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_w, gate_e = jax.lax.top_k(probs, k)
    gate_w = gate_w / jnp.maximum(gate_w.sum(-1, keepdims=True), 1e-9)
    flat_e = gate_e.reshape(-1)
    sort_idx = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = jnp.bincount(flat_e, length=e)
    offsets = jnp.cumsum(counts) - counts
    pos_sorted = jnp.arange(n * k) - offsets[sorted_e]
    pos = jnp.zeros(n * k, jnp.int32).at[sort_idx].set(
        pos_sorted.astype(jnp.int32))
    cap = jmlp._capacity(n, jcfg)
    return tuple(np.asarray(a) for a in (probs, gate_w, gate_e, pos,
                                         pos < cap))


def margin_holds(params, x, jcfg):
    probs = jax_routing(params, x, jcfg)[0]
    margin = routing_margin(torch.from_numpy(probs), jcfg.top_k)
    assert margin > ROUTING_MARGIN, margin


def port_run(params, x, g, cfg, dtype=torch.float32):
    """``(out, aux, {leaf: grad}, x's grad)`` of ``sum(out * g) + aux``."""
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in params.items()}
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    out, aux = mlp.moe_apply(tp, tx, cfg)
    (out.to(torch.float32) * torch.from_numpy(g)).sum().add(aux).backward()
    return (out.detach(), aux.detach(), {k: t.grad for k, t in tp.items()},
            tx.grad)


def rel(got, want) -> float:
    got = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_routing_equals_the_reference(case):
    cfg, jcfg = moe_cfgs(case)
    params, x, _ = np_inputs(case)
    margin_holds(params, x, jcfg)
    probs, gate_w, gate_e, pos, keep = jax_routing(params, x, jcfg)
    n = B * S
    logits = torch.from_numpy(x).reshape(n, -1) @ torch.from_numpy(
        params["router"])
    r = mlp.route(logits, cfg)
    np.testing.assert_array_equal(r.gate_e.numpy(), gate_e)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.gate_w.numpy(), gate_w, rtol=0,
                               atol=GATE_ATOL)
    assert r.capacity == jmlp._capacity(n, jcfg)
    # the buffer holds each kept (token, slot) at (its expert, its rank)
    slots = r.slots.numpy()
    flat_e = gate_e.reshape(-1)
    for i in np.flatnonzero(keep):
        assert slots[flat_e[i], pos[i]] == i
    assert (slots < n * cfg.top_k).sum() == keep.sum()
    if case == "starved":
        assert not keep.all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_output_and_aux_equal_the_reference(case, dtype):
    cfg, jcfg = moe_cfgs(case)
    params, x, _ = np_inputs(case)
    margin_holds(params, x, jcfg)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want, jaux = jmlp.moe_apply({k: jnp.asarray(a) for k, a in
                                 params.items()},
                                jnp.asarray(x).astype(jd), jcfg)
    with torch.no_grad():
        got, aux = mlp.moe_apply({k: torch.from_numpy(a)
                                  for k, a in params.items()},
                                 torch.from_numpy(x).to(td), cfg)
    assert got.dtype == td and tuple(got.shape) == (B, S, cfg.d_model)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert rel(got, want) <= (F32_RTOL if dtype == "float32" else BF16_RTOL)
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_equal_jax_grad(case):
    cfg, jcfg = moe_cfgs(case)
    params, x, g = np_inputs(case)
    margin_holds(params, x, jcfg)
    (want, _), vjp = jax.vjp(lambda p, xx: jmlp.moe_apply(p, xx, jcfg),
                             {k: jnp.asarray(a) for k, a in params.items()},
                             jnp.asarray(x))
    jp, jx = vjp((jnp.asarray(g), jnp.float32(1.0)))
    _, _, grads, gx = port_run(params, x, g, cfg)
    assert rel(gx, jx) <= GRAD_RTOL
    for k in params:
        if case == "top1" and k == "router":
            continue
        assert rel(grads[k], jp[k]) <= GRAD_RTOL, k
    if case != "top1":
        return
    # top-1: the normalised gate weight is 1, so the output reaches the
    # router only as rounding residue; the auxiliary loss's gradient of
    # the router is held on its own
    _, vjp_aux = jax.vjp(lambda r: jmlp.moe_apply(
        dict({k: jnp.asarray(a) for k, a in params.items()}, router=r),
        jnp.asarray(x), jcfg), jnp.asarray(params["router"]))
    (j_aux,) = vjp_aux((jnp.zeros_like(want), jnp.float32(1.0)))
    _, _, aux_grads, _ = port_run(params, x, np.zeros_like(g), cfg)
    assert rel(aux_grads["router"], j_aux) <= GRAD_RTOL
    (j_out,) = vjp_aux((jnp.asarray(g), jnp.float32(0.0)))
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in params.items()}
    out, _ = mlp.moe_apply(tp, torch.from_numpy(x), cfg)
    (out * torch.from_numpy(g)).sum().backward()
    d_gate = np.abs((g * np.asarray(want)).sum(-1)).reshape(-1)
    bound = float(np.finfo(np.float32).eps * (
        np.abs(x).reshape(B * S, -1).max(-1) * d_gate).sum())
    assert np.abs(np.asarray(j_out)).max() <= bound
    assert float(tp["router"].grad.abs().max()) <= bound


@pytest.mark.parametrize("case", list(CASES))
def test_two_runs_are_bitwise_the_same(case):
    cfg, _ = moe_cfgs(case)
    params, x, g = np_inputs(case, seed=1)
    a, b = port_run(params, x, g, cfg), port_run(params, x, g, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[3], b[3])
    for k in params:
        assert torch.equal(a[2][k], b[2][k]), k


def test_deterministic_algorithms_accept_the_block():
    """Forward and backward under ``torch.use_deterministic_algorithms
    (True)``: no op of the routing, the gathers or the products raises,
    and the gradients are the same bits as without it."""
    cfg, _ = moe_cfgs("qwen3")
    params, x, g = np_inputs("qwen3", seed=2)
    want = port_run(params, x, g, cfg)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = port_run(params, x, g, cfg)
    finally:
        torch.use_deterministic_algorithms(before)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    for k in params:
        assert torch.equal(got[2][k], want[2][k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_one_pass_on_meta_tensors(case):
    cfg, _ = moe_cfgs(case)
    params = {k: torch.empty(p.shape, device="meta", requires_grad=True)
              for k, p in mlp.moe_spec(cfg).items()}
    x = torch.empty((B, S, cfg.d_model), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    out, aux = mlp.moe_apply(params, x, cfg)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (B, S, cfg.d_model) and aux.shape == ()
    grads = torch.autograd.grad(out.float().sum() + aux, [x, *params.values()])
    assert all(gr.device.type == "meta" for gr in grads)


@pytest.mark.parametrize("case", ["qwen3", "grok", "top1"])
def test_no_drops_at_the_no_drop_capacity(case):
    """``capacity_factor = E / k`` makes the capacity the token count: no
    slot drops, whatever the routing."""
    cfg, jcfg = moe_cfgs(case)
    cfg = cfg._replace(capacity_factor=cfg.n_experts / cfg.top_k)
    params, x, _ = np_inputs(case)
    n = B * S
    r = mlp.route(torch.from_numpy(x).reshape(n, -1)
                  @ torch.from_numpy(params["router"]), cfg)
    assert r.capacity == n and bool(r.keep.all())


@pytest.mark.parametrize("n", [1, 7, 48, 4096, 32768])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_capacity_and_spec_equal_the_reference(arch, n):
    cfg = lm._moe_cfg(configs.get_config(arch))
    jcfg = jlm._moe_cfg(jconfigs.get_config(arch))
    assert tuple(cfg) == tuple(jcfg)
    assert mlp._capacity(n, cfg) == jmlp._capacity(n, jcfg)
    got, want = mlp.moe_spec(cfg), jmlp.moe_spec(jcfg)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k]) == tuple(want[k])


def test_the_block_makes_no_host_sync():
    """No ``.item()``, ``.tolist()``, ``.cpu()``, ``nonzero`` or
    ``bincount`` (which reads its input's maximum back to the host) in
    the routing, the gathers, the auxiliary loss or the block."""
    for fn in (mlp.route, mlp.moe_apply, mlp._aux, mlp._Gather):
        src = inspect.getsource(fn)
        for bad in (".item()", ".tolist()", ".cpu()", "nonzero", "bincount",
                    "int(", "float(", "bool("):
            assert bad not in src, (fn.__name__, bad)
