"""Grouped-query attention over the whole sequence (train and prefill), on
PyTorch. The twin of ``repro.models.attention``'s ``full``.

Covers MHA (kv = heads) and GQA (kv < heads), causal and bidirectional,
optional QK-norm, RoPE (in the encoder too). The arithmetic follows the
reference: q, k and v projected in the compute dtype; scores as float32
``q·k`` divided by ``sqrt(head_dim)``; a float32 softmax; ``P·V`` in
float32 cast back to the compute dtype; the ``wo`` product in the compute
dtype. Not ``F.scaled_dot_product_attention``: its backend changes with
the shape, and with it the arithmetic.

Sharded (``par``, a :class:`~repro_torch.models.common.Parallel`): ``wq``,
``wk`` and ``wv`` are column-parallel over this rank's heads, so q, k, v,
the scores and ``P·V`` are those of its heads alone, unchanged per head;
``wo`` is row-parallel, and its ``(s, d)`` partial is folded over the
heads' group (:func:`~repro_torch.distributed.sharding.fold_partials`);
``x`` enters the heads' group (``Parallel.enter``), so its gradient is
summed over the heads. Heads that the mesh does not divide run whole and
fold nothing. Where the query heads split and the kv heads do not (GQA
with fewer kv heads than "model" ranks: ``spec_for`` leaves them whole),
each rank takes the kv heads its query heads read, ``[q_lo // group,
ceil(q_hi / group))``, from the whole ``wk`` and ``wv``; those enter the
heads' group first, so their gradient (each rank's a part of it) is
folded there and whole on every rank. A rank's query heads must fill
whole groups or lie in one group; any other placement is refused. Ranks
that share a kv head repeat its projection. The QK-norm scales are whole
on every rank, which normalises its heads alone: they enter the heads'
group, so their gradients are folded there.

The decode step (:func:`decode_step`, the twin of the reference's) runs
one token against a :class:`KVCache`, bf16 whatever the compute dtype,
``(b, max_s, kv, hd)`` a leaf: the new k and v written at ``index`` in
place (the reference's ``dynamic_update_slice`` under donation), from a
0-d device tensor with no host sync, and the attention over all
``max_s`` positions under the ``k_positions <= index`` mask, with the
softmax decomposed (:func:`_decode_attend`: the maximum, the exp-sum and
``P·V`` kept apart until one division), so that a cache split along the
sequence folds the same three terms. Sharded (``par`` and the cache's
``spec_for`` entry of :func:`cache_axes`), the cache holds this rank's
kv heads where "model" divides them, and the step is ``full``'s tensor
parallelism; where it does not (``"cache_seq"``), it holds a block of
the sequence for every kv head: q is gathered over the heads' group, k
and v of the new token made whole, the rank whose block holds ``index``
writes them (a clamped local index and a ``torch.where`` on the old row),
every head attends over the block, the maxima are taken over the
sequence's group (:func:`~repro_torch.distributed.sharding.max_over`)
and the exp-sums and ``P·V`` folded there in rank order, then ``wo`` is
row-parallel over this rank's heads and folded. Every rank gets the same
bits, and a one-rank mesh the unsharded step's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.models import common
from repro_torch.models.common import P


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    norm: str = "rmsnorm"
    q_chunk: int = 1024   # query-block size: caps the live score buffer


def spec(cfg: AttnConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    s = {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = common.norm_spec(hd, cfg.norm)
        s["k_norm"] = common.norm_spec(hd, cfg.norm)
    return s


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` in ``x``'s dtype, as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(params: dict, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qk_norm:
        q = common.apply_norm(q, params["q_norm"], cfg.norm)
        k = common.apply_norm(k, params["k_norm"], cfg.norm)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """float32 ``q·k / sqrt(head_dim)``: (b, sq, h, hd) x (b, sk, kv, hd)
    -> (b, kv, group, sq, sk), the query heads grouped by the kv head they
    read."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32))
    return common.true_divide(scores, math.sqrt(hd))


def _sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: AttnConfig, q_positions: torch.Tensor,
                k_positions: torch.Tensor,
                k_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One query block: (b, sq, h, hd) x (b, sk, kv, hd) -> (b, sq, h, hd),
    the (kv, group) head dims merged as in the reference."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    sk = k.shape[1]
    scores = _scores(q, k).reshape(b, h, sq, sk)
    neg = torch.finfo(torch.float32).min
    if cfg.causal:
        causal = q_positions[:, None] >= k_positions[None, :]   # (sq, sk)
        scores = torch.where(causal[None, None, :, :], scores, neg)
    if k_mask is not None:                                      # (b, sk)
        scores = torch.where(k_mask[:, None, None, :], scores, neg)
    attn = torch.softmax(scores, dim=-1)
    attn = attn.reshape(b, kv, group, sq, sk)
    out = torch.einsum("bkgqs,bskh->bqkgh", attn, v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: AttnConfig, q_positions: torch.Tensor,
          k_positions: torch.Tensor,
          k_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Query-chunked attention: the live score buffer is capped at
    ``(b, h, q_chunk, sk)``; each query row still sees all its keys, so the
    per-block softmax is exact. Causal blocks skip the keys past their
    last query."""
    sq = q.shape[1]
    qc = cfg.q_chunk
    if sq <= qc:
        return _sdpa_block(q, k, v, cfg, q_positions, k_positions, k_mask)
    outs = []
    for lo in range(0, sq, qc):
        hi = min(lo + qc, sq)
        k_end = min(hi, k.shape[1]) if cfg.causal else k.shape[1]
        outs.append(_sdpa_block(
            q[:, lo:hi], k[:, :k_end], v[:, :k_end], cfg,
            q_positions[lo:hi], k_positions[:k_end],
            None if k_mask is None else k_mask[:, :k_end]))
    return torch.cat(outs, dim=1)


def kv_heads_of_rank(cfg: AttnConfig, group) -> tuple[int, int]:
    """``[kv_lo, kv_hi)``: the kv heads this rank's query heads (its block
    of ``n_heads`` over ``group``) read. Raises unless every rank's query
    heads fill whole groups of ``n_heads // kv_heads`` or lie in one."""
    g = cfg.n_heads // cfg.kv_heads
    k = dist.get_world_size(group)
    n = cfg.n_heads // k
    for r in range(k):
        lo, hi = r * n, (r + 1) * n
        if not (lo % g == 0 and hi % g == 0) and lo // g != (hi - 1) // g:
            raise ValueError(
                f"{cfg.n_heads} query heads in groups of {g} over {k} ranks: "
                f"rank {r}'s heads [{lo}, {hi}) neither fill whole groups "
                f"nor lie in one")
    q_lo, q_hi = sharding.local_range(cfg.n_heads, group)
    return q_lo // g, -(-q_hi // g)


def full(params: dict, x: torch.Tensor, cfg: AttnConfig,
         positions: torch.Tensor | None = None,
         par: common.Parallel | None = None) -> torch.Tensor:
    """Training / prefill attention over the whole sequence; with ``par``,
    over this rank's heads, folded."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    group = None
    if par is not None:
        decl = spec(cfg)
        group = par.group(decl["wq"], "heads")
        kv_group = par.group(decl["wk"], "kv_heads")
        if group is None and kv_group is not None:
            raise ValueError(f"the kv heads split over the mesh and the "
                             f"query heads do not: {par.spec(decl['wq'])}")
        kv_whole = group is not None and kv_group is None
        x = par.enter(x, decl["wq"], "heads")
        if group is not None and cfg.qk_norm:
            # the QK-norm scales are whole on every rank, each of which
            # normalises its heads alone: their gradients are folded
            params = dict(params, **{k: common.tree_map(
                lambda w: sharding.enter_group(w, group), params[k])
                for k in ("q_norm", "k_norm")})
        if kv_whole:
            kv_lo, kv_hi = kv_heads_of_rank(cfg, group)
            params = dict(params, **{k: sharding.enter_group(params[k], group)
                                     for k in ("wk", "wv")})
        params = dict(params, **{k: par.gather(params[k], decl[k])
                                 for k in ("wq", "wk", "wv", "wo")})
        if kv_whole:
            params = dict(params, **{k: params[k][:, kv_lo:kv_hi]
                                     for k in ("wk", "wv")})
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _sdpa(q, k, v, cfg, positions, positions)
    h, hd, d = params["wo"].shape
    out = out.reshape(b, s, h * hd) @ params["wo"].to(x.dtype).reshape(
        h * hd, d)
    return out if group is None else sharding.fold_partials(out, group)


class KVCache(NamedTuple):
    """Decode-time cache: the keys and values of the positions so far."""
    k: torch.Tensor     # (b, max_s, kv, hd)
    v: torch.Tensor     # (b, max_s, kv, hd)


def cache_spec(cfg: AttnConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16) -> KVCache:
    """The cache as meta tensors (the twin of the reference's
    ``ShapeDtypeStruct`` pair)."""
    shape = (batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return KVCache(torch.empty(shape, dtype=dtype, device="meta"),
                   torch.empty(shape, dtype=dtype, device="meta"))


def cache_axes() -> KVCache:
    """The cache's logical axes. ``"cache_seq"`` (not ``"act_seq"``): where
    the kv heads do not divide "model", ``spec_for`` gives "model" to the
    sequence instead (``"act_kv_heads"`` outranks it)."""
    ax = ("act_batch", "cache_seq", "act_kv_heads", None)
    return KVCache(ax, ax)


def init_cache(cfg: AttnConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str | None = None) -> KVCache:
    shape = (batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _write(cache: torch.Tensor, new: torch.Tensor, index: torch.Tensor,
           lo: int) -> None:
    """``new`` (b, 1, kv, hd) into ``cache``, a block of the sequence that
    starts at position ``lo``, at the global position ``index`` (0-d), in
    place: the row is written where the block holds it and rewritten with
    its old value elsewhere (a clamped local index, so no host sync)."""
    at = index.reshape(1).to(torch.int64) - lo
    here = (at >= 0) & (at < cache.shape[1])
    at = at.clamp(0, cache.shape[1] - 1)
    row = torch.where(here, new.to(cache.dtype), cache.index_select(1, at))
    cache.index_copy_(1, at, row)


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   index: torch.Tensor, lo: int, seq_group=None
                   ) -> torch.Tensor:
    """One query position (b, 1, n, hd) against the cache block ``k``, ``v``
    (b, s, kv, hd) of positions ``[lo, lo + s)``, the keys past ``index``
    masked: float32 scores, their maximum ``m``, ``e = exp(s - m)``, its
    sum ``z`` and ``P·V = e·v``, then ``P·V / z`` in ``q``'s dtype. Over
    ``seq_group`` (the blocks of the sequence) ``m`` is every rank's
    maximum and ``z`` and ``P·V`` are folded in rank order."""
    b, _, n, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    scores = _scores(q, k)                                  # (b, kv, g, 1, s)
    pos = torch.arange(lo, lo + s, device=q.device)
    scores = torch.where(pos <= index, scores,
                         torch.finfo(torch.float32).min)
    m = scores.amax(dim=-1, keepdim=True)
    if seq_group is not None:
        m = sharding.max_over(m, seq_group)
    e = torch.exp(scores - m)
    z = e.sum(dim=-1)                                       # (b, kv, g, 1)
    pv = torch.einsum("bkgqs,bskh->bqkgh", e, v.to(torch.float32))
    if seq_group is not None:
        z = sharding.fold_partials(z, seq_group)
        pv = sharding.fold_partials(pv, seq_group)
    z = z.reshape(b, n)[:, None, :, None]
    return (pv.reshape(b, 1, n, hd) / z).to(q.dtype)


def _heads_block(t: torch.Tensor, have, axes, lo: int, hi: int,
                 par: common.Parallel) -> torch.Tensor:
    """Heads ``[lo, hi)`` (dim 2), the block the spec entry ``axes`` gives
    this rank (all heads for None), of ``t``, which holds the block the
    entry ``have`` gives it: ``t`` itself where the entries agree, else a
    slice of ``t`` made whole (gathered over ``have``'s group in rank
    order)."""
    if have == axes:
        return t
    if have is not None:
        t = sharding.all_gather_cat(t, sharding.axis_group(par.mesh, have),
                                    dim=2)
    return t[:, :, lo:hi]


def decode_step(params: dict, x: torch.Tensor, cache: KVCache,
                index: torch.Tensor, cfg: AttnConfig,
                par: common.Parallel | None = None,
                cache_spec: tuple | None = None
                ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: ``x`` (b, 1, d); ``cache`` holds ``index`` valid
    positions (``index`` a 0-d int tensor on ``x``'s device) and takes the
    new token's k and v at ``index``, in place. Returns ``(out (b, 1, d),
    cache)``.

    With ``par``, ``params`` are this rank's blocks, ``cache`` is this
    rank's block of the whole cache under ``cache_spec`` (its
    :func:`~repro_torch.distributed.sharding.spec_for` entry of
    :func:`cache_axes`), and ``out`` is the whole, the same on every rank
    of the heads' group."""
    b = x.shape[0]
    h, kv = cfg.n_heads, cfg.kv_heads
    g = h // kv
    seq_group = heads_group = None
    c_lo, c_hi, lo = 0, kv, 0
    if par is not None:
        decl = spec(cfg)
        q_axes = par.spec(decl["wq"])[1]
        k_axes = par.spec(decl["wk"])[1]
        _, seq_axes, c_axes, _ = cache_spec
        params = dict(params, **{k: par.gather(params[k], decl[k])
                                 for k in ("wq", "wk", "wv", "wo")})
        if c_axes is not None:
            c_lo, c_hi = sharding.local_range(
                kv, sharding.axis_group(par.mesh, c_axes))
        if seq_axes is not None:
            seq_group = sharding.axis_group(par.mesh, seq_axes)
            lo = dist.get_rank(seq_group) * cache.k.shape[1]
        if q_axes is not None:
            heads_group = sharding.axis_group(par.mesh, q_axes)
    q, k_new, v_new = _project_qkv(params, x, cfg, index.reshape(1))
    if par is not None:
        # the query heads the cache's kv heads serve, and those kv heads
        q = _heads_block(q, q_axes, c_axes, c_lo * g, c_hi * g, par)
        k_new, v_new = (_heads_block(t, k_axes, c_axes, c_lo, c_hi, par)
                        for t in (k_new, v_new))
    _write(cache.k, k_new, index, lo)
    _write(cache.v, v_new, index, lo)
    out = _decode_attend(q, cache.k, cache.v, index, lo, seq_group)
    if par is not None:
        # the row-parallel wo takes this rank's heads
        q_lo, q_hi = (0, h) if heads_group is None else \
            sharding.local_range(h, heads_group)
        out = _heads_block(out, c_axes, q_axes, q_lo, q_hi, par)
    d = params["wo"].shape[-1]
    out = out.reshape(b, 1, -1) @ params["wo"].to(x.dtype).reshape(-1, d)
    out = out if heads_group is None else sharding.fold_partials(
        out, heads_group)
    return out, cache
