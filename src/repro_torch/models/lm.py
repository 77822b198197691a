"""The LM model facade on PyTorch, for the transformer families the port
runs. The twin of ``repro.models.lm``'s ``Model`` (``spec``, ``init``,
``forward``) for the ``encoder`` family without experts: embeds in, the
pre-norm transformer stack, the final norm, the unembedding.

The reference's sharding hints (``shard``, ``_seq_gather``,
``_opt_barrier``) do nothing without a mesh and are dropped, and so is
``remat`` (the port runs no backward pass here). Layers are stacked on a
leading axis (``scan_layers=True``) or kept as a list, as in the
reference; the stack runs as a Python loop over the layers. Token
embeddings, experts, the hybrid and xLSTM families, ``loss`` and the decode
step come with the LM zoo (``ROADMAP.md`` §1 item 7).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import pin_detector_matmul
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mlp

PORTED_FAMILIES = ("encoder",)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _attn_cfg(cfg: ModelConfig) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim,
        causal=cfg.causal and not cfg.is_encoder,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, norm=cfg.norm)


def _mlp_cfg(cfg: ModelConfig) -> mlp.MLPConfig:
    return mlp.MLPConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                         activation=cfg.activation,
                         gated=cfg.activation == "silu")


def _tf_layer_spec(cfg: ModelConfig) -> dict:
    return {
        "attn_norm": common.norm_spec(cfg.d_model, cfg.norm),
        "attn": attention.spec(_attn_cfg(cfg)),
        "mlp_norm": common.norm_spec(cfg.d_model, cfg.norm),
        "mlp": mlp.spec(_mlp_cfg(cfg)),
    }


def _tf_layer(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """Pre-norm transformer block."""
    a = common.apply_norm(x, params.get("attn_norm"), cfg.norm)
    x = x + attention.full(params["attn"], a, _attn_cfg(cfg))
    m = common.apply_norm(x, params.get("mlp_norm"), cfg.norm)
    return x + mlp.apply(params["mlp"], m, _mlp_cfg(cfg))


def layer_params(layers, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views) or of a list of trees."""
    if isinstance(layers, list):
        return layers[i]
    return common.tree_map(lambda a: a[i], layers)


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in PORTED_FAMILIES or cfg.n_experts \
                or not cfg.embeds_in:
            raise ValueError(
                f"{cfg.arch_id}: the port's Model runs the embeds-in "
                f"{PORTED_FAMILIES} family without experts; family "
                f"{cfg.family!r} comes with the LM zoo, ROADMAP.md §1 item 7")
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)

    def spec(self) -> dict:
        cfg = self.cfg
        layer = _tf_layer_spec(cfg)
        s: dict[str, Any] = {
            "final_norm": common.norm_spec(cfg.d_model, cfg.norm),
            "unembed": common.unembed_spec(cfg.vocab, cfg.d_model),
            "layers": (common.map_layers(layer, cfg.n_layers)
                       if cfg.scan_layers
                       else [layer for _ in range(cfg.n_layers)]),
        }
        return s

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``param_dtype``, drawn on the generator's
        device."""
        return common.init_params(generator, self.spec(),
                                  dtype_of(self.cfg.param_dtype))

    def _trunk(self, params: dict, embeds: torch.Tensor) -> torch.Tensor:
        """Embeds in -> layer stack -> final norm: the hidden states."""
        cfg = self.cfg
        h = embeds.to(self.compute_dtype)
        for i in range(cfg.n_layers):
            h = _tf_layer(layer_params(params["layers"], i), h, cfg)
        return common.apply_norm(h, params.get("final_norm"), cfg.norm)

    def forward(self, params: dict, embeds: torch.Tensor) -> torch.Tensor:
        """``(b, s, d_model)`` embeddings -> ``(b, s, vocab)`` logits in the
        compute dtype (the reference's ``forward`` with ``Batch(embeds=...)``;
        its MoE auxiliary loss is always 0 here and is not returned). Its
        products run in :func:`~repro_torch.pin_detector_matmul`'s scope:
        float32 ones in full float32, bf16 ones reduced in float32, as the
        reference's dots accumulate, whatever the caller's flags."""
        with pin_detector_matmul():
            h = self._trunk(params, embeds)
            return common.unembed(params["unembed"], h, self.compute_dtype)
