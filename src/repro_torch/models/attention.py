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
that share a kv head repeat its projection.

``KVCache`` and ``decode_step`` come with the decode cell
(``ROADMAP.md`` §1 item 4(b)).
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


def _sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: AttnConfig, q_positions: torch.Tensor,
                k_positions: torch.Tensor,
                k_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One query block: (b, sq, h, hd) x (b, sk, kv, hd) -> (b, sq, h, hd),
    the (kv, group) head dims merged as in the reference."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32))
    scores = common.true_divide(scores, math.sqrt(hd))
    sk = k.shape[1]
    scores = scores.reshape(b, h, sq, sk)
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
