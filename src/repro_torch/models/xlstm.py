"""xLSTM blocks on PyTorch [arXiv:2405.04517]: the mLSTM (matrix memory,
chunkwise parallel) and the sLSTM (scalar memory, strictly recurrent),
with exponential gating and max-stabilisers. The twin of
``repro.models.xlstm``.

The mLSTM runs in the reference's chunkwise-parallel form:
:func:`mlstm_parallel`'s phase A (each chunk's state contribution) and
phase C (the within-chunk quadratic form against the carried state) are
vectorised over the chunks, and phase B, the cheap ``(C, n, m)`` carry
recurrence, is a Python loop over the chunks in the reference scan's
order. Its multi-operand einsums are pairwise products in a fixed order
(``S_c = (ws * k)^T v``, ``num = (qk * s_intra) v``), so that their
arithmetic and the FLOPs ``FlopCounterMode`` counts do not depend on the
host's einsum path; the sums over one index (``n_c``, ``den``, ``q·n``)
are reductions, not products. The decode step is the one-token
recurrence :func:`mlstm_step`.

The sLSTM's time loop runs through one custom op,
``repro_torch::slstm_scan`` (:func:`slstm_scan`), whose body is the
plain loop of :func:`_slstm_cell` steps on whatever device its tensors
are on. It has a fake (meta tensors cost one call a block, not one a
token: the dry run counts every layer on them), a FLOP formula
(``2·b·s·4·h·dh²``: the recurrent products) and an autograd formula whose
backward function runs the plain loop again under ``enable_grad`` on
detached inputs and takes ``torch.autograd.grad`` of it: the gradient is
autograd's gradient of the plain loop, bit for bit, also under
``torch.utils.checkpoint``. On meta tensors that function calls a
second op, ``repro_torch::slstm_scan_backward``, which has only a fake
and a count: what autograd runs there (the recompute's ``s`` products,
``s`` for the gradient of ``r``, ``s - 1`` for the hidden state's, ``s``
when the initial state takes a gradient).

The rounding follows the reference on purpose: ``k / sqrt(dh)`` in the
compute dtype in :func:`mlstm_parallel` (the divisor rounded to it) and
in float32 in :func:`mlstm_step`; the gates' pre-activations made in the
compute dtype, then cast to float32; ``v`` from the convolution's input,
``q`` and ``k`` from its output; the mLSTM's output cast back before an
RMSNorm that spans all of ``d_inner``; the decode step's convolution
over a buffer rounded to the state's dtype (bf16 by default, even in a
float32 config); the stabilisers ``m`` starting at 0.

Sharded (``par``, a :class:`~repro_torch.models.common.Parallel`), the
heads split over the mesh dims the rules give ``"ssm_heads"`` (the
decode state's ``"act_ssm_heads"``). Where those dims do not divide the
heads (xlstm-350m's 4 over a "model" of 16), the heads run whole on
every rank of "model" and every weight split there is gathered whole
(:func:`~repro_torch.distributed.sharding.gather_alike`: every rank then
runs the same products, so its backward pass keeps this rank's block of
the gradient); the dry run counts that repetition. Where they divide,
each rank runs its heads: the stored blocks are not one rank's heads
(``w_up``'s ``x_m | z`` columns, the sLSTM's gate-major ``z | i | f |
o`` columns), so the forward gathers what its heads need (the whole
``x_m``, the convolution, ``wq``/``wk``/``wv``'s rows) and cuts them,
the layer norm's output entering the heads' group; the out-norm's sum of
squares is folded over that group in rank order and the out
projection's rows are this rank's heads' channels (the sLSTM's
``w_down``, whole on "model", cut to them), its partial folded.

The decode states (:class:`MLSTMState`, :class:`SLSTMState`) are written
in place by the block steps. Sharded, their heads' dims hold this rank's
heads; the mLSTM's convolution buffer is whole on every rank, which
updates it alike from the whole ``x_m``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import sharding
from repro_torch.models import common
from repro_torch.models.common import P
from repro_torch.models.ssm import _causal_conv, _merged

F32 = torch.float32


class XLSTMConfig(NamedTuple):
    d_model: int
    n_heads: int
    proj_factor: float = 2.0     # mLSTM inner expansion
    d_conv: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel + single step
# ---------------------------------------------------------------------------

def mlstm_parallel(q, k, v, igate, fgate, chunk: int):
    """Full-sequence mLSTM: ``(b, s, h, dh)`` q, k, v and ``(b, s, h)``
    gate pre-activations -> ``(hs (b, s, h, dh) in q's dtype, (C, n, m))``,
    the final float32 carry. ``s`` must be a multiple of ``chunk``
    (``ValueError``; the reference asserts)."""
    b, s, h, dh = q.shape
    if s % chunk:
        raise ValueError(f"a sequence of {s} is no multiple of the mLSTM "
                         f"chunk {chunk}")
    c = s // chunk
    k = common.true_divide(k, math.sqrt(dh))
    flog = F.logsigmoid(fgate.to(F32))

    def to_chunks(t):   # (b, s, h, ...) -> (b, h, c, q, ...)
        return t.reshape(b, c, chunk, h, *t.shape[3:]).movedim(3, 1)

    qc, kc, vc = (to_chunks(t.to(F32)) for t in (q, k, v))
    ic = to_chunks(igate.to(F32))                          # (b, h, c, q)
    fc = to_chunks(flog)

    # phase A: per-chunk aggregates (vectorised over c)
    Fc = torch.cumsum(fc, dim=-1)
    F_tot = Fc[..., -1]                                    # (b, h, c)
    w_state = ic + (F_tot[..., None] - Fc)
    m_state = w_state.amax(dim=-1)                         # (b, h, c)
    wk = torch.exp(w_state - m_state[..., None])[..., None] * kc
    S_c = wk.transpose(-1, -2) @ vc                        # (b,h,c,dh,dh)
    n_c = wk.sum(dim=-2)                                   # (b, h, c, dh)

    # phase B: the carry recurrence over the chunks, in the scan's order
    C_p = torch.zeros((b, h, dh, dh), dtype=F32, device=q.device)
    n_p = torch.zeros((b, h, dh), dtype=F32, device=q.device)
    m_p = torch.zeros((b, h), dtype=F32, device=q.device)
    prev = []
    for i in range(c):
        prev.append((C_p, n_p, m_p))
        f_tot, m_st = F_tot[:, :, i], m_state[:, :, i]
        m_new = torch.maximum(m_p + f_tot, m_st)
        dec = torch.exp(m_p + f_tot - m_new)
        w_i = torch.exp(m_st - m_new)
        C_p = dec[..., None, None] * C_p + w_i[..., None, None] * S_c[:, :, i]
        n_p = dec[..., None] * n_p + w_i[..., None] * n_c[:, :, i]
        m_p = m_new
    C_prev, n_prev, m_prev = (torch.stack(t, dim=2) for t in zip(*prev))

    # phase C: within-chunk form against the carried state (vectorised)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    D = Fc[..., :, None] - Fc[..., None, :] + ic[..., None, :]
    D = torch.where(tri, D, -torch.inf)
    m_inter = Fc + m_prev[..., None]
    m_eff = torch.maximum(D.amax(dim=-1), m_inter)         # (b, h, c, q)
    qk_s = (qc @ kc.transpose(-1, -2)) * torch.exp(D - m_eff[..., None])
    w_inter = torch.exp(m_inter - m_eff)
    num = qk_s @ vc + w_inter[..., None] * (qc @ C_prev)
    den = qk_s.sum(dim=-1) + w_inter * (qc * n_prev[..., None, :]).sum(-1)
    h_t = num / torch.maximum(den.abs(), torch.exp(-m_eff))[..., None]
    hs = h_t.reshape(b, h, s, dh).movedim(1, 2)            # (b, s, h, dh)
    return hs.to(q.dtype), (C_p, n_p, m_p)


def _step_into(q, k, v, igate, fgate, C, n, m) -> torch.Tensor:
    """The one-token recurrence with the carry ``(C, n, m)`` written in
    place: ``(b, h, dh)`` float32 output."""
    dh = q.shape[-1]
    k = common.true_divide(k.to(F32), math.sqrt(dh))
    q, v = q.to(F32), v.to(F32)
    flog = F.logsigmoid(fgate.to(F32))
    m_new = torch.maximum(flog + m, igate)
    fw = torch.exp(flog + m - m_new)
    iw = torch.exp(igate - m_new)
    C.mul_(fw[..., None, None]).add_(
        iw[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n.mul_(fw[..., None]).add_(iw[..., None] * k)
    m.copy_(m_new)
    num = (q[..., None, :] @ C)[..., 0, :]
    den = torch.maximum((q * n).sum(dim=-1).abs(), torch.exp(-m))
    return num / den[..., None]


def mlstm_step(q, k, v, igate, fgate, carry):
    """One-token recurrence. q, k, v: (b, h, dh); gates: (b, h) float32.
    ``(h (b, h, dh) float32, (C, n, m))``, the carry new tensors."""
    C, n, m = (t.clone() for t in carry)
    return _step_into(q, k, v, igate, fgate, C, n, m), (C, n, m)


# ---------------------------------------------------------------------------
# Heads under a mesh
# ---------------------------------------------------------------------------

class _Heads(NamedTuple):
    """This rank's heads ``[lo, hi)``, the mesh dims (a spec entry) they
    split over and their group (None, None where they run whole)."""
    lo: int
    hi: int
    axes: object
    group: object


def _heads(n_heads: int, par: common.Parallel | None, axes) -> _Heads:
    if par is None or axes is None:
        return _Heads(0, n_heads, None, None)
    group = sharding.axis_group(par.mesh, axes)
    lo, hi = sharding.local_range(n_heads, group)
    return _Heads(lo, hi, axes, group)


def _weight(w: torch.Tensor, decl: P, heads: _Heads,
            par: common.Parallel | None, **cuts) -> torch.Tensor:
    """``w``, this rank's block of ``decl``, whole but for ``cuts`` (a
    logical dim's name -> the ``[lo, hi)`` pieces of it to keep,
    concatenated): FSDP's ``"embed"`` dim gathered; with the heads whole,
    every other split dim gathered alike
    (:func:`~repro_torch.distributed.sharding.gather_alike`); with them
    split, a dim split over the heads' dims kept where its block is the
    pieces, else gathered (its backward pass sums every rank's
    gradient), and a block the heads' dims do not split entering their
    group."""
    if par is not None:
        w = par.gather(w, decl)
        split_by_heads = False
        for dim, axes in enumerate(par.spec(decl)):
            name = decl.axes[dim]
            if axes is None or name == "embed":
                continue
            g = sharding.axis_group(par.mesh, axes)
            if heads.group is None:
                w = sharding.gather_alike(w, g, dim)
                continue
            if axes != heads.axes:
                raise ValueError(f"the xLSTM's {name!r} dim splits over "
                                 f"{axes} and its heads over {heads.axes}")
            split_by_heads = True
            if name in cuts and _merged(cuts[name]) == [
                    sharding.local_range(decl.shape[dim], g)]:
                cuts = {k: v for k, v in cuts.items() if k != name}
                continue
            w = sharding.all_gather_cat(w, g, dim)
        if heads.group is not None and not split_by_heads:
            w = sharding.enter_group(w, heads.group)
    for name, pieces in cuts.items():
        dim = decl.axes.index(name)
        pieces = _merged(pieces)
        if pieces == [(0, w.shape[dim])]:
            continue
        parts = [w.narrow(dim, lo, hi - lo) for lo, hi in pieces]
        w = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return w


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, n: int, group=None,
              eps: float = 1e-6) -> torch.Tensor:
    """``common.rms_norm`` over all ``n`` channels, of which ``x`` and
    ``scale`` hold this rank's: the float32 sum of squares folded over the
    heads' ``group`` in rank order (its gradient folded there too),
    divided by ``n``."""
    ss = x.to(F32).square().sum(dim=-1, keepdim=True)
    if group is not None:
        ss = sharding.enter_group(sharding.fold_partials(ss, group), group)
    out = x * torch.rsqrt(common.true_divide(ss, n) + eps).to(x.dtype)
    return out * scale.to(x.dtype)


def _out(params: dict, decl: dict, y: torch.Tensor, z: torch.Tensor | None,
         n: int, heads: _Heads, hp: list, par) -> torch.Tensor:
    """The out-norm over all ``n`` channels (``hp``: this rank's), the
    gate ``silu(z)`` where there is one, and the row-parallel
    ``w_down``, its partial folded over the heads' group."""
    scale = _weight(params["out_norm"]["scale"], decl["out_norm"]["scale"],
                    heads, par, norm=hp)
    y = _rms_norm(y, scale, n, heads.group)
    if z is not None:
        y = y * F.silu(z)
    w = _weight(params["w_down"], decl["w_down"], heads, par,
                **{decl["w_down"].axes[0]: hp})
    out = y @ w.to(y.dtype)
    return out if heads.group is None else sharding.fold_partials(
        out, heads.group)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM v1 pre-up-projection block)
# ---------------------------------------------------------------------------

def mlstm_spec(cfg: XLSTMConfig) -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "norm": common.norm_spec(d, "layernorm"),
        "w_up": P((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": P((cfg.d_conv, di), ("conv_k", "conv_dim")),
        "conv_b": P((di,), ("conv_dim",), "zeros"),
        "wq": P((di, di), ("ssm_inner", "qkv_dim")),
        "wk": P((di, di), ("ssm_inner", "qkv_dim")),
        "wv": P((di, di), ("ssm_inner", "qkv_dim")),
        "w_i": P((di, h), ("ssm_inner", "ssm_heads"), "normal", 0.01),
        "b_i": P((h,), ("ssm_heads",), "zeros"),
        "w_f": P((di, h), ("ssm_inner", "ssm_heads"), "normal", 0.01),
        "b_f": P((h,), ("ssm_heads",), "ones"),
        "out_norm": {"scale": P((di,), ("norm",), "ones")},
        "w_down": P((di, d), ("ssm_inner", "embed")),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor      # (b, h, dh, dh) float32
    n: torch.Tensor      # (b, h, dh) float32
    m: torch.Tensor      # (b, h) float32
    conv: torch.Tensor   # (b, d_conv - 1, d_inner)


def mlstm_state_spec(cfg: XLSTMConfig, batch: int,
                     conv_dtype: torch.dtype = torch.bfloat16
                     ) -> MLSTMState:
    """The state as meta tensors (the twin of the reference's
    ``ShapeDtypeStruct``s)."""
    dh, h, di = cfg.head_dim, cfg.n_heads, cfg.d_inner

    def meta(shape, dt=F32):
        return torch.empty(shape, dtype=dt, device="meta")
    return MLSTMState(meta((batch, h, dh, dh)), meta((batch, h, dh)),
                      meta((batch, h)),
                      meta((batch, cfg.d_conv - 1, di), conv_dtype))


def mlstm_state_axes() -> MLSTMState:
    return MLSTMState(("act_batch", "act_ssm_heads", None, None),
                      ("act_batch", "act_ssm_heads", None),
                      ("act_batch", "act_ssm_heads"),
                      ("act_batch", None, None))


def init_mlstm_state(cfg: XLSTMConfig, batch: int,
                     conv_dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str | None = None
                     ) -> MLSTMState:
    return MLSTMState(*(torch.zeros(t.shape, dtype=t.dtype, device=device)
                        for t in mlstm_state_spec(cfg, batch, conv_dtype)))


def _mlstm_qkv_gates(params, x_norm, cfg, heads, par, conv_fn):
    """This rank's heads' q, k and v, the float32 gate pre-activations
    ``(..., h_loc)`` and ``z`` of the heads' channels; ``x_m`` and its
    convolution whole."""
    dt = x_norm.dtype
    decl = mlstm_spec(cfg)
    di, dh = cfg.d_inner, cfg.head_dim
    hp = [(heads.lo * dh, heads.hi * dh)]
    hh = [(heads.lo, heads.hi)]
    if heads.group is not None:
        x_norm = sharding.enter_group(x_norm, heads.group)

    def w(name, **cuts):
        return _weight(params[name], decl[name], heads, par,
                       **cuts).to(dt)
    up = x_norm @ w("w_up", ssm_inner=[(0, di), (di + hp[0][0],
                                                 di + hp[0][1])])
    x_m, z = torch.split(up, [di, hp[0][1] - hp[0][0]], dim=-1)
    x_c = conv_fn(x_m)
    q = x_c @ w("wq", qkv_dim=hp)
    k = x_c @ w("wk", qkv_dim=hp)
    v = x_m @ w("wv", qkv_dim=hp)
    ig = (x_c @ w("w_i", ssm_heads=hh) + w("b_i", ssm_heads=hh)).to(F32)
    fg = (x_c @ w("w_f", ssm_heads=hh) + w("b_f", ssm_heads=hh)).to(F32)
    return q, k, v, ig, fg, z


def _conv_weights(params, cfg, heads, par, dt):
    decl = mlstm_spec(cfg)
    return (_weight(params["conv_w"], decl["conv_w"], heads, par).to(dt),
            _weight(params["conv_b"], decl["conv_b"], heads, par).to(dt))


def mlstm_block(params: dict, x: torch.Tensor, cfg: XLSTMConfig,
                par: common.Parallel | None = None) -> torch.Tensor:
    """Full-sequence mLSTM block (residual inside): (b, s, d) -> same.
    With ``par``, over this rank's heads, folded."""
    b, s, _ = x.shape
    dt = x.dtype
    heads = _heads(cfg.n_heads, par, None if par is None else par.spec(
        mlstm_spec(cfg)["b_i"])[0])
    h_loc, dh = heads.hi - heads.lo, cfg.head_dim
    x_norm = common.apply_norm(x, params["norm"], "layernorm")
    cw, cb = _conv_weights(params, cfg, heads, par, dt)
    q, k, v, ig, fg, z = _mlstm_qkv_gates(
        params, x_norm, cfg, heads, par, lambda x_m: _causal_conv(x_m, cw,
                                                                  cb))
    ht, _ = mlstm_parallel(q.reshape(b, s, h_loc, dh),
                           k.reshape(b, s, h_loc, dh),
                           v.reshape(b, s, h_loc, dh), ig, fg,
                           min(cfg.chunk, s))
    out = _out(params, mlstm_spec(cfg), ht.reshape(b, s, h_loc * dh), z,
               cfg.d_inner, heads, [(heads.lo * dh, heads.hi * dh)], par)
    return x + out


def mlstm_block_step(params: dict, x: torch.Tensor, state: MLSTMState,
                     cfg: XLSTMConfig, par: common.Parallel | None = None,
                     state_spec: MLSTMState | None = None
                     ) -> tuple[torch.Tensor, MLSTMState]:
    """One-token mLSTM block: ``x`` (b, 1, d) -> ``(x + out, state)``,
    ``state`` written in place (the reference returns a new one). With
    ``par``, ``state`` is this rank's block under ``state_spec`` (each
    leaf's spec): its heads' C, n and m, the convolution buffer whole."""
    b = x.shape[0]
    dt = x.dtype
    heads = _heads(cfg.n_heads, par, None if par is None else
                   state_spec.C[1])
    h_loc, dh = heads.hi - heads.lo, cfg.head_dim
    x_norm = common.apply_norm(x[:, 0, :], params["norm"], "layernorm")
    cw, cb = _conv_weights(params, cfg, heads, par, dt)

    def conv_fn(x_m):   # the buffer rounded to its dtype, as the reference
        buf = torch.cat([state.conv, x_m[:, None, :].to(state.conv.dtype)],
                        dim=1)
        out = (buf.to(dt) * cw).sum(dim=1)
        state.conv.copy_(buf[:, 1:])
        return F.silu(out + cb)

    q, k, v, ig, fg, z = _mlstm_qkv_gates(params, x_norm, cfg, heads, par,
                                          conv_fn)
    ht = _step_into(q.reshape(b, h_loc, dh), k.reshape(b, h_loc, dh),
                    v.reshape(b, h_loc, dh), ig, fg, state.C, state.n,
                    state.m)
    out = _out(params, mlstm_spec(cfg), ht.reshape(b, h_loc * dh).to(dt),
               z, cfg.d_inner, heads, [(heads.lo * dh, heads.hi * dh)], par)
    return x + out[:, None, :], state


# ---------------------------------------------------------------------------
# sLSTM block — strictly recurrent scalar memory
# ---------------------------------------------------------------------------

def slstm_spec(cfg: XLSTMConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = cfg.s_head_dim
    return {
        "norm": common.norm_spec(d, "layernorm"),
        "w": P((d, 4 * d), ("embed", "ssm_inner")),
        "r": P((4, h, dh, dh), (None, "ssm_heads", None, None),
               "normal", 0.02),
        "b": P((4 * d,), ("ssm_inner",), "zeros"),
        "out_norm": {"scale": P((d,), ("norm",), "ones")},
        "w_down": P((d, d), ("embed", "embed")),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor     # (b, h, dh) float32
    n: torch.Tensor
    hid: torch.Tensor
    m: torch.Tensor


def slstm_state_spec(cfg: XLSTMConfig, batch: int) -> SLSTMState:
    return SLSTMState(*(torch.empty((batch, cfg.n_heads, cfg.s_head_dim),
                                    dtype=F32, device="meta")
                        for _ in range(4)))


def slstm_state_axes() -> SLSTMState:
    ax = ("act_batch", "act_ssm_heads", None)
    return SLSTMState(ax, ax, ax, ax)


def init_slstm_state(cfg: XLSTMConfig, batch: int,
                     device: torch.device | str | None = None
                     ) -> SLSTMState:
    return SLSTMState(*(torch.zeros(t.shape, dtype=F32, device=device)
                        for t in slstm_state_spec(cfg, batch)))


def _slstm_cell(x: torch.Tensor, r_t: torch.Tensor, st: SLSTMState
                ) -> tuple[torch.Tensor, SLSTMState]:
    """One step, heads leading: ``x`` (h, b, 4 * dh) float32
    pre-activations from the input path (a head's z | i | f | o), ``r_t``
    the recurrence as ``(h, dh_in, 4 * dh)``, the state's leaves ``(h, b,
    dh)``. The reference's ``_slstm_cell`` in its order; the recurrent
    product and its sum with ``x`` are one ``baddbmm``."""
    zt, it, ft, ot = torch.baddbmm(x, st.hid, r_t).chunk(4, dim=-1)
    fm = ft + st.m
    m_new = torch.maximum(fm, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(fm - m_new)
    c_new = f_p * st.c + i_p * torch.tanh(zt)
    n_new = f_p * st.n + i_p
    hid = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return hid, SLSTMState(c_new, n_new, hid, m_new)


def scan_loop(wx, r, c, n, hid, m):
    """The plain sLSTM loop: ``wx`` (b, s, 4, h, dh) pre-activations (any
    float dtype), ``r`` (4, h, dh, dh), the float32 ``(b, h, dh)`` state
    -> the float32 hidden states (b, s, h, dh) and the final state's four
    leaves. A step a token, heads leading: the state's leaves carried as
    ``(h, b, dh)``, so each step's recurrent product is one batched
    matmul over the heads."""
    b, s, _, h, dh = wx.shape
    r_t = r.to(F32).permute(1, 3, 0, 2).reshape(h, dh, 4 * dh)
    xs = wx.to(F32).permute(1, 3, 0, 2, 4).reshape(s, h, b, 4 * dh)
    st = SLSTMState(*(t.transpose(0, 1).contiguous()
                      for t in (c, n, hid, m)))
    hids = []
    for x in xs.unbind(0):
        out, st = _slstm_cell(x, r_t, st)
        hids.append(out)
    return (torch.stack(hids).permute(2, 0, 1, 3),
            *(t.transpose(0, 1).contiguous() for t in st))


Tensors5 = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]
Tensors6 = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor]


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def slstm_scan(wx: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
               n: torch.Tensor, hid: torch.Tensor, m: torch.Tensor
               ) -> Tensors5:
    """:func:`scan_loop` as one op: ``(hids, c, n, hid, m)``, new
    tensors."""
    hids, *st = scan_loop(wx, r, c, n, hid, m)
    return hids.contiguous(), *st


@slstm_scan.register_fake
def _(wx, r, c, n, hid, m):
    b, s, _, h, dh = wx.shape
    return (wx.new_empty((b, s, h, dh), dtype=F32),
            *(t.new_empty(t.shape) for t in (c, n, hid, m)))


@torch.library.custom_op("repro_torch::slstm_scan_backward",
                         mutates_args=())
def slstm_scan_backward(wx: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                        n: torch.Tensor, hid: torch.Tensor, m: torch.Tensor,
                        g_hids: torch.Tensor, need_r: bool, need_h0: bool
                        ) -> Tensors6:
    """The gradients of :func:`slstm_scan`'s inputs as fake tensors: what
    the dry run counts of its backward pass on meta tensors. On a device
    the backward pass runs the plain loop again instead."""
    raise NotImplementedError("slstm_scan_backward has a fake and a FLOP "
                              "count only (meta tensors)")


@slstm_scan_backward.register_fake
def _(wx, r, c, n, hid, m, g_hids, need_r, need_h0):
    return tuple(torch.empty_like(t) for t in (wx, r, c, n, hid, m))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)
    ctx.set_materialize_grads(False)


def _backward(ctx, *grads):
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad
    if saved[0].device.type == "meta":
        g_hids = grads[0] if grads[0] is not None else torch.empty(
            saved[0].shape[:2] + saved[0].shape[3:], dtype=F32,
            device="meta")
        got = slstm_scan_backward(*saved, g_hids, need[1], need[4])
        return tuple(g if ok else None for g, ok in zip(got, need))
    return scan_grads(saved, need, grads)


def scan_grads(saved, need, grads) -> tuple:
    """The gradients of :func:`slstm_scan`'s inputs ``saved`` flagged in
    ``need`` (None for the others), for the outputs' gradients ``grads``
    (None for an output unused): :func:`scan_loop` again under
    ``enable_grad`` on detached inputs, and ``torch.autograd.grad`` of
    it."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(ok) for t, ok in zip(saved, need)]
        outs = scan_loop(*ins)
        used = [(o, g) for o, g in zip(outs, grads) if g is not None]
        got = iter(torch.autograd.grad(
            [o for o, _ in used], [t for t, ok in zip(ins, need) if ok],
            [g for _, g in used], allow_unused=True))
    return tuple(next(got) if ok else None for ok in need)


slstm_scan.register_autograd(_backward, setup_context=_setup)


def _scan_products(wx_shape) -> int:
    """FLOPs of one step's recurrent products, every token of the batch."""
    b, _, _, h, dh = wx_shape
    return 2 * b * 4 * h * dh * dh


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _scan_flops(wx_shape, *args, out_shape=None, **kwargs) -> int:
    return wx_shape[1] * _scan_products(wx_shape)


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _scan_backward_flops(wx_shape, r_shape, c_shape, n_shape, hid_shape,
                         m_shape, g_shape, need_r, need_h0, *args,
                         out_shape=None, **kwargs) -> int:
    """The recompute's products, the gradient of ``r`` at every step, the
    hidden state's at every step but the first (and there where the
    initial state takes a gradient)."""
    s = wx_shape[1]
    return (s + s * need_r + s - 1 + need_h0) * _scan_products(wx_shape)


def slstm_block(params: dict, x: torch.Tensor, cfg: XLSTMConfig,
                state: SLSTMState | None = None,
                par: common.Parallel | None = None,
                state_spec: SLSTMState | None = None
                ) -> tuple[torch.Tensor, SLSTMState]:
    """Sequence sLSTM block (residual inside): ``(x + out, final
    state)``, the time loop one :func:`slstm_scan` call. ``state``: the
    float32 ``(b, h, dh)`` state to start from (zeros by default). With
    ``par``, over this rank's heads (the state's, under ``state_spec``,
    where one is given), folded."""
    b, s, d = x.shape
    dt = x.dtype
    decl = slstm_spec(cfg)
    axes = None
    if par is not None:
        axes = (state_spec.c[1] if state_spec is not None
                else par.spec(decl["r"])[1])
    heads = _heads(cfg.n_heads, par, axes)
    h_loc, dh = heads.hi - heads.lo, cfg.s_head_dim
    x_norm = common.apply_norm(x, params["norm"], "layernorm")
    if heads.group is not None:
        x_norm = sharding.enter_group(x_norm, heads.group)
    cols = [(g * d + heads.lo * dh, g * d + heads.hi * dh) for g in range(4)]
    w = _weight(params["w"], decl["w"], heads, par, ssm_inner=cols)
    bias = _weight(params["b"], decl["b"], heads, par, ssm_inner=cols)
    wx = (x_norm @ w.to(dt) + bias.to(dt)).reshape(b, s, 4, h_loc, dh)
    r = _weight(params["r"], decl["r"], heads, par,
                ssm_heads=[(heads.lo, heads.hi)])
    if state is None:
        state = SLSTMState(*(torch.zeros((b, h_loc, dh), dtype=F32,
                                         device=x.device) for _ in range(4)))
    hids, *st = slstm_scan(wx, r, *state)
    hp = [(heads.lo * dh, heads.hi * dh)]
    out = _out(params, decl, hids.reshape(b, s, h_loc * dh).to(dt), None, d,
               heads, hp, par)
    return x + out, SLSTMState(*st)


def slstm_block_step(params: dict, x: torch.Tensor, state: SLSTMState,
                     cfg: XLSTMConfig, par: common.Parallel | None = None,
                     state_spec: SLSTMState | None = None
                     ) -> tuple[torch.Tensor, SLSTMState]:
    """One-token sLSTM block: ``x`` (b, 1, d) -> ``(x + out, state)``,
    ``state`` written in place (the reference returns a new one)."""
    out, new = slstm_block(params, x, cfg, state, par, state_spec)
    for t, u in zip(state, new):
        t.copy_(u)
    return out, state
