"""Feed-forward blocks on PyTorch: SwiGLU (llama family) or the plain GELU
MLP (encoders), and the top-k mixture of experts. The twin of
``repro.models.mlp``.

Every product runs in the input's (compute) dtype, as in the reference.
Sharded (``par``): ``w_up`` and ``w_gate`` column-parallel over this
rank's block of ``d_ff`` (``x`` entering its group), ``w_down``
row-parallel, its partial folded over that block's group; a ``d_ff`` the
mesh does not divide runs whole.

The mixture of experts (:func:`moe_apply`) keeps the reference's
capacity-bounded, sort-based dispatch step by step: a float32 router, its
softmax and top-k (the first k of a stable descending sort: ``lax.top_k``
puts the lower index first on a tie), the Switch auxiliary loss, each
(token, slot) ranked within its expert by a stable sort, slots past the
capacity dropped, one gather of token rows into the ``(E, C, d)`` buffer
(optionally of int8 rows with per-token scales), three batched products,
and each slot's output weighted and summed over the k slots in order.
The expert counts come from ``searchsorted`` over the sorted expert ids,
not ``bincount`` (which reads its input's maximum back to the host and
has no meta kernel). The buffer's gather and the return gather are
:class:`_Gather`, whose backward pass is itself a gather with the k
slots of a token summed in order: no scatter-add, so no atomics.

Sharded, the reference's global routing is kept: the token matrix is
gathered over the mesh dims that split the batch
(:meth:`~repro_torch.models.common.Parallel.token_group`), every rank
routes every token (the same bits on every rank), runs its block of
experts over ``"model"`` (``"expert"``; where ``"model"`` does not
divide the expert count, its block of every expert's ``d_ff``,
``"expert_mlp"``, as the dense MLP does), and takes back its own tokens'
slot outputs, which are folded over ``"model"`` before the weighting and
the k-sum (each slot is nonzero on one rank alone where the experts
split, so the fold adds exact zeros). The auxiliary loss's value is the
global one on every rank; its gradient runs through this rank's tokens'
share of ``mean(probs)`` alone, folded over the batch's group as
``Model.loss`` folds the NLL, so the gathered tokens' backward pass
counts it once. The reference's activation hints (``act_expert``,
``act_expert_cap``) constrain GSPMD and are dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.common import P, Parallel, true_divide


class MLPConfig(NamedTuple):
    d_model: int
    d_ff: int
    activation: str = "silu"     # silu (llama family) | gelu (encoders)
    gated: bool = True


def spec(cfg: MLPConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {"w_up": P((d, f), ("embed", "mlp")),
         "w_down": P((f, d), ("mlp", "embed"))}
    if cfg.gated:
        s["w_gate"] = P((d, f), ("embed", "mlp"))
    return s


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``jax.nn.silu``, or ``jax.nn.gelu``, whose default is the tanh form
    (``F.gelu``'s default is the erf form)."""
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def apply(params: dict, x: torch.Tensor, cfg: MLPConfig,
          par: Parallel | None = None) -> torch.Tensor:
    dt = x.dtype
    group = None
    if par is not None:
        decl = spec(cfg)
        group = par.group(decl["w_down"], "mlp")
        x = par.enter(x, decl["w_up"], "mlp")
        params = {k: par.gather(w, decl[k]) for k, w in params.items()}
    up = x @ params["w_up"].to(dt)
    if cfg.gated:
        h = _act(x @ params["w_gate"].to(dt), cfg.activation) * up
    else:
        h = _act(up, cfg.activation)
    out = h @ params["w_down"].to(dt)
    return out if group is None else sharding.fold_partials(out, group)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    router_aux_weight: float = 0.01
    dispatch_int8: bool = False   # quantize the dispatch gather payload


def moe_spec(cfg: MoEConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": P((d, e), ("embed", "expert")),
        "w_gate": P((e, d, f), ("expert", "embed", "expert_mlp")),
        "w_up": P((e, d, f), ("expert", "embed", "expert_mlp")),
        "w_down": P((e, f, d), ("expert", "expert_mlp", "embed")),
    }


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, cfg.top_k)


class Routing(NamedTuple):
    """The routing of ``n`` tokens: ``probs`` ``(n, E)`` float32, ``gate_w``
    ``(n, k)`` float32 (normalised) and ``gate_e`` ``(n, k)`` int64 (in
    descending order of probability); per (token, slot), flattened as
    ``t * k + j``: ``pos``, its rank within its expert, and ``keep``,
    ``pos < capacity``; ``slots`` ``(E, C)``, the flat (token, slot)
    index each buffer entry holds, ``n * k`` where it holds none."""
    probs: torch.Tensor
    gate_w: torch.Tensor
    gate_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slots: torch.Tensor
    capacity: int


def route(logits: torch.Tensor, cfg: MoEConfig) -> Routing:
    """The reference's routing of ``(n, E)`` float32 router logits (its
    ``moe_apply`` up to the dispatch), with no host sync: the experts'
    offsets in the stably sorted expert ids by ``searchsorted``, each
    slot's rank its sorted position less its expert's offset, taken back
    to slot order by the inverse permutation (an argsort of the sort's
    permutation), and buffer entry ``(e, c)`` the sorted position
    ``offsets[e] + c`` where ``c`` is below the expert's count."""
    n, e = logits.shape
    k = cfg.top_k
    cap = _capacity(n, cfg)
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = vals[:, :k], idx[:, :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    nk = n * k
    flat_e = gate_e.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    offsets = torch.searchsorted(sorted_e, torch.arange(e + 1, device=dev))
    pos_sorted = torch.arange(nk, device=dev) - offsets[sorted_e]
    pos = pos_sorted[torch.argsort(order)]
    at = offsets[:e, None] + torch.arange(cap, device=dev)
    slots = torch.where(at < offsets[1:, None],
                        order[torch.clamp(at, max=nk - 1)], nk)
    return Routing(probs, gate_w, gate_e, pos, pos < cap, slots, cap)


class _Gather(torch.autograd.Function):
    """``rows`` ``(m, w)`` -> ``(*index.shape, w)``: row ``index[...]`` of
    ``rows``, a zero row where ``index`` is ``m``. Its backward pass is a
    gather too: source row ``i``'s gradient is the sum, in order, of the
    output rows ``back[i, :]`` (flat indices into the output, its length
    where none), so no scatter-add runs."""

    @staticmethod
    def forward(ctx, rows, index, back):
        ctx.save_for_backward(back)
        pad = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        return pad[index]

    @staticmethod
    def backward(ctx, grad):
        back, = ctx.saved_tensors
        w = grad.shape[-1]
        flat = torch.cat([grad.reshape(-1, w), grad.new_zeros((1, w))])
        parts = flat[back]
        acc = parts[:, 0]
        for j in range(1, parts.shape[1]):
            acc = acc + parts[:, j]
        return acc, None, None


def _aux(r: Routing, cfg: MoEConfig, lo: int, hi: int,
         batch_group) -> torch.Tensor:
    """The Switch loss ``w * E * sum(mean(probs) * mean(one_hot(top-1)))``
    over every routed token. Where ``batch_group`` is given and ``probs``
    takes a gradient, that gradient runs through the share of tokens
    ``[lo, hi)`` (this rank's) alone, its sum and count folded over the
    group, and the value is still the global one."""
    n, e = r.probs.shape
    f32 = torch.float32
    ce = (r.gate_e[:, :1] == torch.arange(e, device=r.probs.device)).to(
        f32).mean(0)
    scale = cfg.router_aux_weight * e

    def loss(total, count):
        return scale * ((total / count) * ce).sum()

    value = loss(r.probs.sum(0), torch.full((), n, dtype=f32,
                                           device=r.probs.device))
    if batch_group is None or not r.probs.requires_grad:
        return value
    total = sharding.fold_partials(r.probs[lo:hi].sum(0), batch_group)
    count = sharding.fold_partials(torch.full(
        (), hi - lo, dtype=f32, device=r.probs.device), batch_group)
    share = loss(total, count)
    return value.detach() + (share - share.detach())


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              par: Parallel | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(b, s, d)`` -> ``((b, s, d), aux_loss)``: the reference's
    ``moe_apply``. With ``par``, ``params`` are this rank's blocks and
    ``x`` its block of a batch of ``par.batch`` sequences; the output is
    this rank's block, the auxiliary loss the whole batch's."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt, f32 = x.dtype, torch.float32
    xf = x.reshape(b * s, d)
    tokens = expert_group = ffn_group = router_group = batch_group = None
    if par is not None:
        decl = moe_spec(cfg)
        tokens, batch_group = par.token_group(), par.batch_group()
        router_group = par.group(decl["router"], "expert")
        expert_group = par.group(decl["w_gate"], "expert")
        ffn_group = par.group(decl["w_gate"], "expert_mlp")
        if expert_group is not None and ffn_group is not None:
            raise NotImplementedError(
                "experts split both by expert and by d_ff")
        params = {name: par.gather(w, decl[name])
                  for name, w in params.items()}
    xg = xf if tokens is None else sharding.all_gather_cat(xf, tokens)
    n = xg.shape[0]
    lo, hi = (0, n) if tokens is None else sharding.local_range(n, tokens)

    # --- route: every token, the same bits on every rank ---
    router = params["router"].to(f32)
    if router_group is None:
        logits = xg.to(f32) @ router
    else:
        r_lo, r_hi = sharding.local_range(e, router_group)
        part = sharding.enter_group(xg, router_group).to(f32) @ router
        logits = sharding.fold_partials(F.pad(part, (r_lo, e - r_hi)),
                                        router_group)
    r = route(logits, cfg)
    aux = _aux(r, cfg, lo, hi, batch_group)

    # --- this rank's experts: where each (token, slot) sits in its buffer
    cap = r.capacity
    e_lo, e_hi = (0, e) if expert_group is None else sharding.local_range(
        e, expert_group)
    n_buf = (e_hi - e_lo) * cap
    flat_e = r.gate_e.reshape(-1)
    mine = r.keep & (flat_e >= e_lo) & (flat_e < e_hi)
    place = torch.where(mine, (flat_e - e_lo) * cap + r.pos, n_buf)
    place = place.view(n, k)
    slots = r.slots[e_lo:e_hi]

    # --- dispatch: one gather of token rows (or int8 rows and scales) ---
    model_group = expert_group if expert_group is not None else ffn_group
    xe = xg if model_group is None else sharding.enter_group(xg, model_group)
    if cfg.dispatch_int8:
        scale = true_divide(torch.clamp(xe.abs().amax(-1, keepdim=True),
                                        min=1e-6).to(f32), 127.0)
        xq = torch.clamp(torch.round(xe.to(f32) / scale), -127, 127).to(
            torch.int8)
        xq_pad = torch.cat([xq, xq.new_zeros((1, d))])
        buf = (xq_pad[slots // k].to(f32)
               * _Gather.apply(scale, slots // k, place)).to(dt)
    else:
        buf = _Gather.apply(xe, slots // k, place)

    # --- expert compute (batched over this rank's experts) ---
    hidden = _act(torch.bmm(buf, params["w_gate"].to(dt)), cfg.activation) \
        * torch.bmm(buf, params["w_up"].to(dt))
    out_buf = torch.bmm(hidden, params["w_down"].to(dt))

    # --- return: this rank's tokens' slots, folded, weighted, summed ---
    own = torch.where((slots >= lo * k) & (slots < hi * k), slots - lo * k,
                      (hi - lo) * k)
    slot_out = _Gather.apply(out_buf.reshape(n_buf, d), place[lo:hi],
                             own.reshape(n_buf, 1))
    if model_group is not None:
        slot_out = sharding.fold_partials(slot_out, model_group)
    weighted = slot_out * r.gate_w[lo:hi].to(dt)[..., None]
    out = weighted[:, 0]
    for j in range(1, k):
        out = out + weighted[:, j]
    return out.reshape(b, s, d), aux
