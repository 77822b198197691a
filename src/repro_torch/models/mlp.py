"""The dense feed-forward block on PyTorch: SwiGLU (llama family) or the
plain GELU MLP (encoders). The twin of ``repro.models.mlp``'s dense half;
the mixture of experts comes with the LM zoo (``ROADMAP.md`` §1 item 4).

Every product runs in the input's (compute) dtype, as in the reference.
Sharded (``par``): ``w_up`` and ``w_gate`` column-parallel over this
rank's block of ``d_ff`` (``x`` entering its group), ``w_down``
row-parallel, its partial folded over that block's group; a ``d_ff`` the
mesh does not divide runs whole.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.common import P, Parallel


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
