"""The dense feed-forward block on PyTorch: SwiGLU (llama family) or the
plain GELU MLP (encoders). The twin of ``repro.models.mlp``'s dense half;
the mixture of experts comes with the LM zoo (``ROADMAP.md`` §1 item 7).

Every product runs in the input's (compute) dtype, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import P


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


def apply(params: dict, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    dt = x.dtype
    up = x @ params["w_up"].to(dt)
    if cfg.gated:
        h = _act(x @ params["w_gate"].to(dt), cfg.activation) * up
    else:
        h = _act(up, cfg.activation)
    return h @ params["w_down"].to(dt)
