"""Mamba-2 (SSD) blocks on PyTorch: the chunked scan for train and
prefill and the one-token recurrent step for decode. The twin of
``repro.models.ssm``.

The arithmetic follows the reference: the in and out projections and the
depthwise causal convolution in the compute dtype; ``dt`` (softplus of
the projection plus its bias) and ``A = -exp(A_log)`` in float32; the
discretised input ``x * dt`` promoted to float32 (a compute-dtype ``x``
times a float32 ``dt``), ``dt * A``, B and C in float32; the scan's output
cast back to the compute dtype before the ``D`` skip; the gated RMSNorm
over all ``d_inner`` channels. :func:`ssd_chunked` is the reference's
chunked SSD: the within-chunk quadratic form under the ``exp`` of
:func:`_segsum` (a cumsum difference, ``-inf`` above the diagonal), the
chunk states, the inter-chunk recurrence ``s_prev * decay + state`` (a
Python loop over the chunks, in the reference scan's order) and the
off-diagonal term. Its multi-operand einsums are written as pairwise
products in a fixed order, each a batched matmul over the heads of one
group (``repeat_interleave``: head ``i`` reads group ``i // (h // g)``),
so that their arithmetic and the FLOPs ``FlopCounterMode`` counts do not
depend on the host's einsum path; the largest intermediate is the
float32 ``(b, c, h, q, q)`` of the within-chunk form.

Sharded (``par``, a :class:`~repro_torch.models.common.Parallel`), the
heads split over the mesh dims the rules give ``"ssm_heads"``. The
stored blocks keep the spec's layout (``in_proj``'s concatenated z | x |
B | C | dt columns and the convolution's x | B | C channels split in
blocks that are not one rank's heads), so the forward gathers what the
split needs: ``x`` (entering the heads' group) times this rank's
``in_proj`` columns, the projection's output gathered over ``"model"``,
then this rank's heads' z, x and dt columns and its groups' B and C
(whole, for ``n_groups = 1``); the convolution's weights gathered and
cut to the same channels. Autograd folds every rank's part of the
gathered leaves (the gather's backward pass sums the ranks' gradients:
every rank uses B and C). The gated norm's mean of squares is folded
over the heads' group in rank order, and so is its gradient; its scale
is whole on every rank and enters that group. ``out_proj``'s rows are
this rank's heads: row-parallel, its partial folded. A weight whose
split dim is whole while the heads split enters the heads' group, so its
gradient is folded there.

The decode state (:class:`SSMState`) is the float32 ``(b, h, p, n)``
recurrent state and the ``(b, d_conv - 1, conv_dim)`` convolution
buffer (bf16 by default, as the reference's: even the current token's
``xBC`` is rounded to it before the convolution). :func:`decode_step`
writes both in place. Sharded, the recurrent state holds this rank's
heads; the convolution buffer is whole on every rank, which updates it
alike from the whole ``xBC`` (the projection's output gathered).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models import common
from repro_torch.models.common import P


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int         # = expand * d_model (Mamba2 default expand=2)
    n_heads: int         # d_inner // head_dim
    head_dim: int
    d_state: int
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256


def conv_dim(cfg: SSMConfig) -> int:
    """The convolution's channels: x | B | C."""
    return cfg.d_inner + 2 * cfg.n_groups * cfg.d_state


def spec(cfg: SSMConfig) -> dict:
    d, di, h, n, g = (cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_state,
                      cfg.n_groups)
    cd = conv_dim(cfg)
    d_in_proj = 2 * di + 2 * g * n + h
    return {
        "in_proj": P((d, d_in_proj), ("embed", "ssm_inner")),
        "conv_w": P((cfg.d_conv, cd), ("conv_k", "conv_dim")),
        "conv_b": P((cd,), ("conv_dim",), "zeros"),
        "A_log": P((h,), ("ssm_heads",), "zeros"),
        "D": P((h,), ("ssm_heads",), "ones"),
        "dt_bias": P((h,), ("ssm_heads",), "zeros"),
        "norm": {"scale": P((di,), ("norm",), "ones")},
        "out_proj": P((di, d), ("ssm_inner", "embed")),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: SSMConfig):
    """z, x, B, C, dt: the projection's columns."""
    di, g, n, h = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    return torch.split(zxbcdt, [di, di, g * n, g * n, h], dim=-1)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q) lower-triangular segment sums: the cumsum
    difference ``cs[i] - cs[j]``, ``-inf`` above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan: ``(y, final_state)``.

    x: (b, s, h, p); dt: (b, s, h) (post-softplus, float32); A: (h,)
    negative; B, C: (b, s, g, n). ``y`` is (b, s, h, p) in ``x``'s dtype,
    ``final_state`` (b, h, p, n) float32. ``s`` must be a multiple of
    ``chunk`` (``ValueError``) and ``h`` of ``g``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"a sequence of {s} is no multiple of the SSD "
                         f"chunk {chunk}")
    c, q, rep = s // chunk, chunk, h // g
    f32 = torch.float32

    xd = (x * dt[..., None]).to(f32)                       # discretised
    dA = (dt * A).to(f32)                                  # (b, s, h)
    xc = xd.reshape(b, c, q, h, p)
    # (b, c, g, q, n): one group's rows, chunk by chunk
    Bc = B.to(f32).reshape(b, c, q, g, n).permute(0, 1, 3, 2, 4)
    Cc = C.to(f32).reshape(b, c, q, g, n).permute(0, 1, 3, 2, 4)

    dA_t = dA.reshape(b, c, q, h).permute(0, 1, 3, 2)      # (b, c, h, q)
    dA_cs = torch.cumsum(dA_t, dim=-1)
    L = torch.exp(_segsum(dA_t))                           # (b, c, h, q, q)

    # within-chunk (diagonal blocks): (C·B) of each group, times L of
    # each of its heads, times x
    CB = Cc @ Bc.transpose(-1, -2)                         # (b, c, g, q, k)
    M = (L.reshape(b, c, g, rep, q, q) * CB[:, :, :, None]).reshape(
        b, c, h, q, q)
    y_diag = (M @ xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # per-chunk states, (b, c, g, n, rep * p): B of the group against
    # its heads' x weighted by the decay to the chunk's end
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)      # (b, c, h, q)
    xw = xc * decay_states.permute(0, 1, 3, 2)[..., None]
    xw = xw.reshape(b, c, q, g, rep * p).permute(0, 1, 3, 2, 4)
    states = (Bc.transpose(-1, -2) @ xw).reshape(b, c, g, n, rep, p)

    # inter-chunk recurrence, in the reference scan's order
    chunk_decay = torch.exp(dA_cs[..., -1]).reshape(b, c, g, 1, rep, 1)
    s_prev = torch.zeros((b, g, n, rep, p), dtype=f32, device=x.device)
    prev = []
    for i in range(c):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[:, i] + states[:, i]
    prev_states = torch.stack(prev, dim=1).reshape(b, c, g, n, rep * p)

    # off-diagonal: C against the state entering the chunk, decayed
    state_decay_out = torch.exp(dA_cs).permute(0, 1, 3, 2)  # (b, c, q, h)
    y_off = (Cc @ prev_states).permute(0, 1, 3, 2, 4).reshape(
        b, c, q, h, p) * state_decay_out[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    final = s_prev.permute(0, 1, 3, 4, 2).reshape(b, h, p, n)
    return y.to(x.dtype), final


class SSMState(NamedTuple):
    """Decode-time recurrent state."""
    ssm: torch.Tensor       # (b, h, p, n) float32
    conv: torch.Tensor      # (b, d_conv - 1, conv_dim)


def state_spec(cfg: SSMConfig, batch: int,
               conv_dtype: torch.dtype = torch.bfloat16) -> SSMState:
    """The state as meta tensors (the twin of the reference's
    ``ShapeDtypeStruct`` pair)."""
    return SSMState(
        torch.empty((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                    dtype=torch.float32, device="meta"),
        torch.empty((batch, cfg.d_conv - 1, conv_dim(cfg)),
                    dtype=conv_dtype, device="meta"))


def state_axes() -> SSMState:
    return SSMState(("act_batch", "act_ssm_heads", None, None),
                    ("act_batch", None, None))


def init_state(cfg: SSMConfig, batch: int,
               conv_dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str | None = None) -> SSMState:
    return SSMState(*(torch.zeros(t.shape, dtype=t.dtype, device=device)
                      for t in state_spec(cfg, batch, conv_dtype)))


def _causal_conv(xs: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (b, s, c) with kernel (k, c), then
    SiLU: the reference's sum of shifted products, in its order."""
    k, s = w.shape[0], xs.shape[1]
    pad = F.pad(xs, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                d_inner: int, group=None, eps: float = 1e-6
                ) -> torch.Tensor:
    """``common.rms_norm(y * silu(z), scale)`` over all ``d_inner``
    channels, of which ``y``, ``z`` and ``scale`` hold this rank's: the
    float32 sum of squares folded over the heads' ``group`` in rank order
    (its gradient folded there too), divided by ``d_inner``."""
    x = y * F.silu(z)
    ss = x.to(torch.float32).square().sum(dim=-1, keepdim=True)
    if group is not None:
        ss = sharding.enter_group(sharding.fold_partials(ss, group), group)
    var = common.true_divide(ss, d_inner)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    return out * scale.to(x.dtype)


class _Heads(NamedTuple):
    """This rank's heads ``[lo, hi)`` and groups ``[g_lo, g_hi)``, the
    mesh dims (a spec entry) the heads split over and their group (None,
    None where they run whole)."""
    lo: int
    hi: int
    g_lo: int
    g_hi: int
    axes: object
    group: object

    def channels(self, cfg: SSMConfig) -> list[tuple[int, int]]:
        """The x | B | C channels of the heads (of ``conv_dim``)."""
        di, n, g, p = cfg.d_inner, cfg.d_state, cfg.n_groups, cfg.head_dim
        return [(self.lo * p, self.hi * p),
                (di + self.g_lo * n, di + self.g_hi * n),
                (di + (g + self.g_lo) * n, di + (g + self.g_hi) * n)]


def _heads(cfg: SSMConfig, par: common.Parallel | None,
           axes=None) -> _Heads:
    """The heads the mesh dims ``axes`` give this rank (all of them
    without ``par`` or ``axes``). Raises unless they fill whole groups
    of ``n_heads // n_groups`` or lie in one."""
    h, rep = cfg.n_heads, cfg.n_heads // cfg.n_groups
    if par is None or axes is None:
        return _Heads(0, h, 0, cfg.n_groups, None, None)
    group = sharding.axis_group(par.mesh, axes)
    lo, hi = sharding.local_range(h, group)
    if not (lo % rep == 0 and hi % rep == 0) and lo // rep != (hi - 1) // rep:
        raise ValueError(f"{h} SSM heads in groups of {rep}: this rank's "
                         f"heads [{lo}, {hi}) neither fill whole groups nor "
                         f"lie in one")
    return _Heads(lo, hi, lo // rep, -(-hi // rep), axes, group)


def _merged(pieces) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for lo, hi in pieces:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _part(w: torch.Tensor, decl: P, logical: str, pieces, heads: _Heads,
          par: common.Parallel | None) -> torch.Tensor:
    """The ``pieces`` (``[lo, hi)`` ranges) of ``decl``'s ``logical`` dim,
    concatenated, from ``w``, this rank's block of ``decl`` (FSDP's
    ``"embed"`` dim gathered): the block itself where it is those
    pieces; else gathered over the dim's group (whose backward pass sums
    every rank's gradient) and cut; a dim the mesh leaves whole enters
    the heads' group (its gradient folded there) and is cut."""
    dim = decl.axes.index(logical)
    pieces = _merged(pieces)
    if par is not None:
        w = par.gather(w, decl)
        axes = par.spec(decl)[dim]
        if axes is not None:
            if axes != heads.axes:
                raise ValueError(
                    f"the SSM's {logical!r} dim splits over {axes} and its "
                    f"heads over {heads.axes}")
            g = sharding.axis_group(par.mesh, axes)
            if pieces == [sharding.local_range(decl.shape[dim], g)]:
                return w
            w = sharding.all_gather_cat(w, g, dim)
        elif heads.group is not None:
            w = sharding.enter_group(w, heads.group)
    if pieces == [(0, w.shape[dim])]:
        return w
    parts = [w.narrow(dim, lo, hi - lo) for lo, hi in pieces]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _project(params: dict, x: torch.Tensor, cfg: SSMConfig,
             heads: _Heads, par: common.Parallel | None) -> torch.Tensor:
    """``x @ in_proj`` in ``x``'s dtype, whole (every column): with
    ``par``, ``x`` enters the heads' group, meets this rank's columns,
    and the product is gathered over the columns' group (columns the
    mesh leaves whole enter the heads' group, as ``x`` does)."""
    w = params["in_proj"]
    if par is None:
        return x @ w.to(x.dtype)
    decl = spec(cfg)["in_proj"]
    w = par.gather(w, decl)
    axes = par.spec(decl)[1]
    if axes is not None and axes != heads.axes:
        raise ValueError(f"the SSM's in_proj columns split over {axes} and "
                         f"its heads over {heads.axes}")
    if heads.group is not None:
        x = sharding.enter_group(x, heads.group)
        if axes is None:
            w = sharding.enter_group(w, heads.group)
    out = x @ w.to(x.dtype)
    if axes is None:
        return out
    return sharding.all_gather_cat(out, heads.group, out.ndim - 1)


def _heads_cols(z, xs, B, C, dtr, cfg: SSMConfig, heads: _Heads):
    """The heads' columns of z, x and dt and their groups' of B and C."""
    hp = slice(heads.lo * cfg.head_dim, heads.hi * cfg.head_dim)
    gn = slice(heads.g_lo * cfg.d_state, heads.g_hi * cfg.d_state)
    return (z[..., hp], xs[..., hp], B[..., gn], C[..., gn],
            dtr[..., heads.lo:heads.hi])


def _head_params(params: dict, cfg: SSMConfig, heads: _Heads,
                 par: common.Parallel | None) -> dict:
    """``A_log``, ``D``, ``dt_bias``, the norm's scale and ``out_proj``'s
    rows for this rank's heads."""
    decl = spec(cfg)
    hp = [(heads.lo * cfg.head_dim, heads.hi * cfg.head_dim)]
    out = {k: _part(params[k], decl[k], "ssm_heads", [(heads.lo, heads.hi)],
                    heads, par) for k in ("A_log", "D", "dt_bias")}
    out["scale"] = _part(params["norm"]["scale"], decl["norm"]["scale"],
                         "norm", hp, heads, par)
    out["out_proj"] = _part(params["out_proj"], decl["out_proj"],
                            "ssm_inner", hp, heads, par)
    return out


def _out(y: torch.Tensor, z: torch.Tensor, hp: dict, cfg: SSMConfig,
         heads: _Heads) -> torch.Tensor:
    """The gated norm and the row-parallel out projection, folded."""
    y = _gated_norm(y, z, hp["scale"], cfg.d_inner, heads.group)
    out = y @ hp["out_proj"].to(y.dtype)
    return out if heads.group is None else sharding.fold_partials(
        out, heads.group)


def apply(params: dict, x: torch.Tensor, cfg: SSMConfig,
          par: common.Parallel | None = None) -> torch.Tensor:
    """Full-sequence Mamba2 mixer (train / prefill): (b, s, d) -> same.
    ``s`` must be a multiple of ``min(cfg.chunk, s)`` (``ValueError``).
    With ``par``, over this rank's heads, folded."""
    b, s, _ = x.shape
    chunk = min(cfg.chunk, s)
    if s % chunk:
        raise ValueError(f"a sequence of {s} is no multiple of the SSD "
                         f"chunk {chunk}")
    dt_ = x.dtype
    heads = _heads(cfg, par, None if par is None else par.spec(
        spec(cfg)["A_log"])[0])
    z, xs, B, C, dtr = _heads_cols(*_split_proj(
        _project(params, x, cfg, heads, par), cfg), cfg, heads)
    decl = spec(cfg)
    chans = heads.channels(cfg)
    w = _part(params["conv_w"], decl["conv_w"], "conv_dim", chans, heads,
              par)
    cb = _part(params["conv_b"], decl["conv_b"], "conv_dim", chans, heads,
               par)
    xBC = _causal_conv(torch.cat([xs, B, C], -1), w.to(dt_), cb.to(dt_))
    h_loc, g_loc = heads.hi - heads.lo, heads.g_hi - heads.g_lo
    n, p = cfg.d_state, cfg.head_dim
    xs, B, C = torch.split(xBC, [h_loc * p, g_loc * n, g_loc * n], dim=-1)
    hp = _head_params(params, cfg, heads, par)
    dt = F.softplus(dtr.to(torch.float32) + hp["dt_bias"].to(torch.float32))
    A = -torch.exp(hp["A_log"].to(torch.float32))
    xh = xs.reshape(b, s, h_loc, p)
    y, _ = ssd_chunked(xh, dt, A, B.reshape(b, s, g_loc, n),
                       C.reshape(b, s, g_loc, n), chunk)
    y = y + hp["D"].to(y.dtype)[None, None, :, None] * xh
    return _out(y.reshape(b, s, h_loc * p), z, hp, cfg, heads)


def decode_step(params: dict, x: torch.Tensor, state: SSMState,
                cfg: SSMConfig, par: common.Parallel | None = None,
                state_spec: SSMState | None = None) -> torch.Tensor:
    """One-token recurrent step: ``x`` (b, 1, d) -> ``out`` (b, 1, d);
    ``state`` written in place (the reference returns the new state).

    With ``par``, ``state`` is this rank's block under ``state_spec``
    (each leaf's :func:`~repro_torch.distributed.sharding.spec_for` entry
    of :func:`state_axes`): the recurrent state of the heads its entry
    gives this rank, the convolution buffer whole; ``out`` is the whole,
    the same on every rank of the heads' group."""
    b = x.shape[0]
    dt_ = x.dtype
    heads = _heads(cfg, par, None if par is None else state_spec.ssm[1])
    zxbcdt = _project(params, x[:, 0, :], cfg, heads, par)   # (b, dproj)
    z, xs, B, C, dtr = _split_proj(zxbcdt, cfg)

    # conv state update: the whole xBC, rounded to the buffer's dtype
    conv_buf = torch.cat([state.conv, torch.cat([xs, B, C], -1)[
        :, None, :].to(state.conv.dtype)], dim=1)
    decl = spec(cfg)
    whole = [(0, conv_dim(cfg))]
    w = _part(params["conv_w"], decl["conv_w"], "conv_dim", whole, heads,
              par)
    cb = _part(params["conv_b"], decl["conv_b"], "conv_dim", whole, heads,
               par)
    out = (conv_buf.to(dt_) * w.to(dt_)).sum(dim=1)
    xBC = F.silu(out + cb.to(dt_))
    state.conv.copy_(conv_buf[:, 1:])
    xs, B, C = torch.split(xBC, [cfg.d_inner, cfg.n_groups * cfg.d_state,
                                 cfg.n_groups * cfg.d_state], dim=-1)
    z, xs, B, C, dtr = _heads_cols(z, xs, B, C, dtr, cfg, heads)

    hp = _head_params(params, cfg, heads, par)
    h_loc, g_loc = heads.hi - heads.lo, heads.g_hi - heads.g_lo
    p, n = cfg.head_dim, cfg.d_state
    f32 = torch.float32
    dt = F.softplus(dtr.to(f32) + hp["dt_bias"].to(f32))      # (b, h)
    A = -torch.exp(hp["A_log"].to(f32))
    dA = torch.exp(dt * A)                                    # (b, h)
    xh = xs.reshape(b, h_loc, p).to(f32)
    rep = h_loc // g_loc
    Bh = B.reshape(b, g_loc, n).repeat_interleave(rep, dim=1).to(f32)
    Ch = C.reshape(b, g_loc, n).repeat_interleave(rep, dim=1).to(f32)
    dbx = (dt[..., None] * xh)[..., None] * Bh[:, :, None, :]  # (b,h,p,n)
    state.ssm.mul_(dA[..., None, None]).add_(dbx)
    y = (state.ssm @ Ch[..., None])[..., 0]                   # (b, h, p)
    y = y + hp["D"].to(f32)[None, :, None] * xh
    y = y.reshape(b, h_loc * p).to(dt_)
    return _out(y, z, hp, cfg, heads)[:, None, :]
