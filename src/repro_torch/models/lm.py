"""The LM model facade on PyTorch, for the families the port runs. The
twin of ``repro.models.lm``'s ``Model`` (``spec``, ``init``,
``abstract_params``, ``forward``, ``loss``) and ``Batch`` for the
``encoder``, ``dense``, ``moe``, ``vlm``, ``hybrid`` and ``ssm`` families: the
inputs (the encoder's embeddings; the token embeddings; the VLM's image
embeddings ahead of its token embeddings), the layer stack, the final
norm, the unembedding, and the masked NLL over it, plus the experts'
auxiliary loss summed over the layers. The transformer families stack
pre-norm transformer blocks (their feed-forward block the dense MLP, or
the mixture of experts where the config has experts). The hybrid
(zamba2) stacks Mamba-2 layers (:mod:`repro_torch.models.ssm`, each
``x + ssm.apply``) in groups of ``shared_attn_every``, each full group
followed by the one shared attention + MLP block, fed ``x + h0 @
emb_proj`` where ``h0`` is the stack's input; a partial last group has
no shared block. The xLSTM (``ssm``) stacks mLSTM blocks with an sLSTM
block every ``slstm_every`` (:mod:`repro_torch.models.xlstm`, each with
its residual inside), their parameters in two stacks, ``{"mlstm",
"slstm"}``. The VLM's logits and loss cover its text positions alone.

Sharded (``par``, a :class:`~repro_torch.models.common.Parallel` over
the blocks of :meth:`Model.param_specs`), the forward is written out:
the token embedding vocab-parallel over ``"model"`` and folded,
attention and MLP tensor-parallel over ``"model"`` with their row-parallel
partials folded, the experts split over ``"model"`` by expert (or by
``d_ff``) behind one gather of the batch's token matrix, the Mamba-2
layers and the xLSTM blocks by SSM heads, every ``"embed"`` dim (FSDP over ``"data"``) gathered
right before its use, the unembedding this rank's vocab block; norms and
the residual stream replicated. ``Model.loss`` takes the same ``par``
(the vocab-parallel logsumexp), and autograd differentiates the
collectives (:mod:`repro_torch.distributed.sharding`). The reference's
activation hints (``shard``, ``_seq_gather``: the sequence-parallel
residual, ``act_resid_seq``) and ``_opt_barrier`` constrain GSPMD and
are dropped.
Layers are stacked on a leading axis (``scan_layers=True``) or kept as a
list, as in the reference; the stack runs as a Python loop over the
layers, each layer (and each call of the hybrid's shared block) under
``remat`` when a backward pass will need it (``"full"``: a per-layer
``torch.utils.checkpoint``; ``"dots"``: the same checkpoint keeping the
outputs of the products without batch dims, :func:`_remat`). A stacked
tree is unbound once a pass, so the backward pass of its views is one
``stack`` a leaf. The decode step
(``decode_state_spec``, ``init_decode_state``, ``decode_step`` and
:class:`DecodeBatch`) runs one token for the whole stack against its
state, written in place: for the transformer families a stacked bf16
:class:`~repro_torch.models.attention.KVCache` of ``(n_layers, b,
max_s, kv, hd)`` leaves; for the hybrid a dict, ``{"mamba":
SSMState(ssm (n_layers, b, h, p, n) float32, conv (n_layers, b, 3,
conv_dim) bf16), "attn": KVCache((n_shared_calls, b, max_s, kv, hd)
bf16)}``; for the xLSTM a list of one state a block, in layer order
(:class:`~repro_torch.models.xlstm.MLSTMState`: float32 C, n and m and a
bf16 convolution buffer; :class:`~repro_torch.models.xlstm.SLSTMState`:
four float32 leaves). Sharded, each rank holds its block of it under the
:func:`~repro_torch.models.attention.cache_axes`,
:func:`~repro_torch.models.ssm.state_axes` and the xLSTM's state axes,
and the logits are this rank's block of the vocab, as ``forward``'s. The
VLM decodes tokens alone, as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch import pin_detector_matmul, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import attention, common, mlp, ssm, xlstm

PORTED_FAMILIES = ("dense", "encoder", "hybrid", "moe", "ssm", "vlm")
#: the families with a decode step
DECODE_FAMILIES = ("dense", "hybrid", "moe", "ssm", "vlm")


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


def _moe_cfg(cfg: ModelConfig) -> mlp.MoEConfig:
    return mlp.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                         n_experts=cfg.n_experts, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         activation=cfg.activation,
                         dispatch_int8=cfg.moe_dispatch_int8)


def _ssm_cfg(cfg: ModelConfig) -> ssm.SSMConfig:
    return ssm.SSMConfig(
        d_model=cfg.d_model, d_inner=cfg.d_inner, n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
        chunk=cfg.ssm_chunk)


def _xlstm_cfg(cfg: ModelConfig) -> xlstm.XLSTMConfig:
    return xlstm.XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                             chunk=cfg.ssm_chunk)


def _xlstm_kinds(cfg: ModelConfig) -> list[str]:
    """Each block's kind, in layer order: every ``slstm_every``-th an
    sLSTM, the others mLSTM."""
    if not cfg.slstm_every:
        return ["mlstm"] * cfg.n_layers
    return ["slstm" if (i + 1) % cfg.slstm_every == 0 else "mlstm"
            for i in range(cfg.n_layers)]


def _xlstm_segments(cfg: ModelConfig) -> list[tuple]:
    """``[("m", lo, hi) | ("s", idx)]`` runs over the two stacks: each run
    of consecutive mLSTM blocks (``[lo, hi)`` of the mLSTM stack), each
    sLSTM block (``idx`` of its stack)."""
    segs: list[tuple] = []
    m_i = s_i = 0
    for kind in _xlstm_kinds(cfg):
        if kind == "slstm":
            segs.append(("s", s_i))
            s_i += 1
        elif segs and segs[-1][0] == "m":
            segs[-1] = ("m", segs[-1][1], m_i + 1)
            m_i += 1
        else:
            segs.append(("m", m_i, m_i + 1))
            m_i += 1
    return segs


def _hybrid_positions(cfg: ModelConfig) -> list[int]:
    """Mamba-layer indices after which the shared attn block runs."""
    if not cfg.shared_attn_every:
        return []
    return list(range(cfg.shared_attn_every - 1, cfg.n_layers,
                      cfg.shared_attn_every))


def _shared_spec(cfg: ModelConfig) -> dict:
    """The hybrid's shared attention + MLP block and its embedding
    re-injection."""
    return {
        "attn_norm": common.norm_spec(cfg.d_model, cfg.norm),
        "attn": attention.spec(_attn_cfg(cfg)),
        "mlp_norm": common.norm_spec(cfg.d_model, cfg.norm),
        "mlp": mlp.spec(_mlp_cfg(cfg)),
        "emb_proj": common.P((cfg.d_model, cfg.d_model),
                             ("embed", "embed")),
    }


def _injected(p: dict, x: torch.Tensor, h0: torch.Tensor, cfg: ModelConfig,
              par: common.Parallel | None) -> torch.Tensor:
    """``x + h0 @ emb_proj`` in ``x``'s dtype (``emb_proj``'s first dim
    gathered under FSDP)."""
    w = p["emb_proj"]
    if par is not None:
        w = par.gather(w, _shared_spec(cfg)["emb_proj"])
    return x + h0 @ w.to(x.dtype)


def _tf_layer_spec(cfg: ModelConfig) -> dict:
    s = {
        "attn_norm": common.norm_spec(cfg.d_model, cfg.norm),
        "attn": attention.spec(_attn_cfg(cfg)),
        "mlp_norm": common.norm_spec(cfg.d_model, cfg.norm),
    }
    if cfg.n_experts:
        s["moe"] = mlp.moe_spec(_moe_cfg(cfg))
    else:
        s["mlp"] = mlp.spec(_mlp_cfg(cfg))
    return s


def _tf_layer(params: dict, x: torch.Tensor, cfg: ModelConfig,
              par: common.Parallel | None = None
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Pre-norm transformer block: ``(x, the experts' auxiliary loss)``,
    None for the auxiliary loss of a block without experts."""
    a = common.apply_norm(x, params.get("attn_norm"), cfg.norm)
    x = x + attention.full(params["attn"], a, _attn_cfg(cfg), par=par)
    m = common.apply_norm(x, params.get("mlp_norm"), cfg.norm)
    if cfg.n_experts:
        out, aux = mlp.moe_apply(params["moe"], m, _moe_cfg(cfg), par)
        return x + out, aux
    return x + mlp.apply(params["mlp"], m, _mlp_cfg(cfg), par=par), None


def _tf_layer_decode(params: dict, x: torch.Tensor,
                     cache: attention.KVCache, index: torch.Tensor,
                     cfg: ModelConfig, par: common.Parallel | None = None,
                     cache_spec: tuple | None = None
                     ) -> tuple[torch.Tensor, attention.KVCache]:
    a = common.apply_norm(x, params.get("attn_norm"), cfg.norm)
    attn_out, cache = attention.decode_step(params["attn"], a, cache, index,
                                            _attn_cfg(cfg), par, cache_spec)
    x = x + attn_out
    m = common.apply_norm(x, params.get("mlp_norm"), cfg.norm)
    if cfg.n_experts:
        out, _ = mlp.moe_apply(params["moe"], m, _moe_cfg(cfg), par)
        return x + out, cache
    return x + mlp.apply(params["mlp"], m, _mlp_cfg(cfg), par=par), cache


def check_decodes(cfg: ModelConfig) -> None:
    """Raise (``ValueError``) unless ``cfg`` has a decode step: the
    encoder has none, as in the reference."""
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode step")
    if cfg.family not in DECODE_FAMILIES:
        raise ValueError(f"{cfg.arch_id}: unknown family {cfg.family!r}")


def layer_params(layers, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views) or of a list of trees."""
    if isinstance(layers, list):
        return layers[i]
    return common.tree_map(lambda a: a[i], layers)


def unbind_layers(layers, n_layers: int) -> list:
    """Every layer's tree of a stacked tree (or the list as it is): the
    views ``layer_params`` takes, made by one ``unbind`` a leaf, whose
    backward pass is one ``stack`` (a view ``a[i]`` a layer would add
    into a zero tensor the size of the whole stack, every layer)."""
    if isinstance(layers, list):
        return layers
    cols = common.tree_map(lambda a: a.unbind(0), layers)
    return [common.tree_map(lambda c: c[i], cols,
                            lambda x: isinstance(x, tuple))
            for i in range(n_layers)]


def map_state(fn: Callable, state):
    """``fn`` at every tensor of a decode state (a ``KVCache``, the
    hybrid's dict of ``SSMState`` and ``KVCache``, or the xLSTM's list of
    per-block states), the structure kept."""
    if isinstance(state, dict):
        return {k: map_state(fn, v) for k, v in state.items()}
    if isinstance(state, list):
        return [map_state(fn, t) for t in state]
    if isinstance(state, tuple):
        return type(state)(*(map_state(fn, t) for t in state))
    return fn(state)


#: the products without batch dims, whose outputs "dots" remat keeps
#: (JAX's ``dots_with_no_batch_dims_saveable``): a 2-D weight against the
#: folded activations (``x @ w`` and ``F.linear`` lower to these)
_DOTS_SAVED = ("mm", "addmm", "mv", "addmv", "dot")
_DOTS_OPS = tuple(getattr(torch.ops.aten, name) for name in _DOTS_SAVED)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the output of a product without batch dims; recompute every
    other op, batched products (``bmm``, ``baddbmm``: the attention scores
    and ``P·V``, the experts, the SSD's and mLSTM's chunk products) and
    the ``repro_torch::slstm_scan`` op among them."""
    pol = torch.utils.checkpoint.CheckpointPolicy
    if getattr(op, "_overloadpacket", None) in _DOTS_OPS:
        return pol.MUST_SAVE
    return pol.PREFER_RECOMPUTE


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn(params, x)`` under the config's rematerialisation: ``"none"``
    keeps its activations for the backward pass; ``"full"`` keeps only
    its inputs and runs it again in the backward pass (a non-reentrant
    ``torch.utils.checkpoint``); ``"dots"`` is that checkpoint with a
    selective policy (:func:`_dots_policy`): the outputs of the products
    without batch dims (the projections, the MLP) are kept, everything
    else runs again, as the reference's ``dots_with_no_batch_dims_saveable``.
    The three give the same values; they differ in what the backward pass
    keeps and recomputes. The checkpoint applies where autograd records
    the call, so a pass without gradients runs ``fn`` itself."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: one of 'full', 'dots', "
                         f"'none'")
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def layer(p, x):
        if not torch.is_grad_enabled() or not (
                x.requires_grad
                or any(t.requires_grad for t in common.leaves(p))):
            return fn(p, x)
        return torch.utils.checkpoint.checkpoint(
            fn, p, x, use_reentrant=False, preserve_rng_state=False, **kw)
    return layer


class Batch(NamedTuple):
    """Inputs for train and prefill: ``tokens`` ``(b, s)`` int32, None for
    the embeds-in configs; ``labels`` ``(b, s)`` int32, -1 marking
    masked-out positions (unread by ``forward``: None will do there);
    ``embeds`` the embeds-in configs' ``(b, s, d_model)`` inputs or the
    VLM's ``(b, n_image_tokens, d_model)`` image prefix, else None."""
    tokens: torch.Tensor | None
    labels: torch.Tensor | None
    embeds: torch.Tensor | None = None


class DecodeBatch(NamedTuple):
    """One decode step's inputs: ``tokens`` ``(b, 1)`` int32; ``index`` the
    0-d int32 cache length (the new token's position), on the device."""
    tokens: torch.Tensor
    index: torch.Tensor


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"{cfg.arch_id}: unknown family "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)

    def spec(self) -> dict:
        cfg = self.cfg
        s: dict[str, Any] = {}
        if not cfg.embeds_in:
            s["embed"] = common.embed_spec(cfg.vocab, cfg.d_model)
        s["final_norm"] = common.norm_spec(cfg.d_model, cfg.norm)
        s["unembed"] = common.unembed_spec(cfg.vocab, cfg.d_model)
        if cfg.family == "hybrid":
            s["layers"] = common.map_layers(ssm.spec(_ssm_cfg(cfg)),
                                            cfg.n_layers)
            s["shared_attn"] = _shared_spec(cfg)
            return s
        if cfg.family == "ssm":
            xc, kinds = _xlstm_cfg(cfg), _xlstm_kinds(cfg)
            s["layers"] = {"mlstm": common.map_layers(
                xlstm.mlstm_spec(xc), kinds.count("mlstm"))}
            if "slstm" in kinds:
                s["layers"]["slstm"] = common.map_layers(
                    xlstm.slstm_spec(xc), kinds.count("slstm"))
            return s
        layer = _tf_layer_spec(cfg)
        s["layers"] = (common.map_layers(layer, cfg.n_layers)
                       if cfg.scan_layers
                       else [layer for _ in range(cfg.n_layers)])
        return s

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``param_dtype``, drawn on the generator's
        device."""
        return common.init_params(generator, self.spec(),
                                  dtype_of(self.cfg.param_dtype))

    def abstract_params(self) -> dict:
        """The parameter tree as meta tensors in ``param_dtype``."""
        return common.abstract_params(self.spec(),
                                      dtype_of(self.cfg.param_dtype))

    def param_specs(self, mesh, rules: dict | None = None) -> dict:
        """Each parameter's spec on ``mesh``: the twin of the reference's
        ``param_shardings``."""
        return common.param_specs(self.spec(), mesh, rules)

    def _image_tokens(self, batch: Batch) -> int:
        """The VLM's image positions ahead of the text (0 for the other
        families and a VLM batch without an image)."""
        cfg = self.cfg
        if cfg.family != "vlm" or cfg.embeds_in or batch.embeds is None:
            return 0
        return batch.embeds.shape[1]

    def _inputs_to_h(self, params: dict, batch: Batch,
                     par: common.Parallel | None = None) -> torch.Tensor:
        """The stack's input: the embeds-in configs' embeddings, else the
        token embeddings, behind the VLM's image prefix."""
        cfg, dt = self.cfg, self.compute_dtype
        if cfg.embeds_in:
            return batch.embeds.to(dt)
        h = common.embed(params["embed"], batch.tokens, dt, par, cfg.vocab,
                         cfg.d_model)
        if self._image_tokens(batch):
            h = torch.cat([batch.embeds.to(dt), h], dim=1)
        return h

    def _trunk(self, params: dict, batch: Batch,
               par: common.Parallel | None = None
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Inputs -> layer stack -> final norm: the hidden states, the text
        positions alone (the VLM's image prefix cut after the stack), and
        the experts' auxiliary loss summed over the layers from a float32
        zero (None without experts)."""
        cfg = self.cfg
        h = self._inputs_to_h(params, batch, par)
        aux = None
        if cfg.family == "hybrid":
            h = self._hybrid_forward(params, h, par)
        elif cfg.family == "ssm":
            h = self._xlstm_forward(params, h, par)
        else:
            layer = _remat(lambda p, x: _tf_layer(p, x, cfg, par), cfg)
            if cfg.n_experts:
                aux = torch.zeros((), dtype=torch.float32, device=h.device)
            for p in unbind_layers(params["layers"], cfg.n_layers):
                h, a = layer(p, h)
                if a is not None:
                    aux = aux + a
        h = common.apply_norm(h, params.get("final_norm"), cfg.norm)
        n_img = self._image_tokens(batch)
        return (h[:, n_img:] if n_img else h), aux

    def _hybrid_forward(self, params: dict, h: torch.Tensor,
                        par: common.Parallel | None) -> torch.Tensor:
        """The Mamba layers in groups of ``shared_attn_every``, each full
        group followed by the shared block fed ``x + h0 @ emb_proj``
        (``h0`` the stack's input); each Mamba layer and each shared-block
        call under ``remat``."""
        cfg = self.cfg
        scfg, acfg, mcfg = _ssm_cfg(cfg), _attn_cfg(cfg), _mlp_cfg(cfg)
        h0 = h
        mamba = _remat(lambda p, x: x + ssm.apply(p, x, scfg, par), cfg)

        def shared_fn(p, x):
            a = common.apply_norm(_injected(p, x, h0, cfg, par),
                                  p["attn_norm"], cfg.norm)
            x = x + attention.full(p["attn"], a, acfg, par=par)
            m = common.apply_norm(x, p["mlp_norm"], cfg.norm)
            return x + mlp.apply(p["mlp"], m, mcfg, par=par)

        shared = _remat(shared_fn, cfg)
        layers = unbind_layers(params["layers"], cfg.n_layers)
        k = cfg.shared_attn_every or cfg.n_layers
        for lo in range(0, cfg.n_layers, k):
            hi = min(lo + k, cfg.n_layers)
            for p in layers[lo:hi]:
                h = mamba(p, h)
            if hi - lo == k and cfg.shared_attn_every:
                h = shared(params["shared_attn"], h)
        return h

    def _xlstm_layers(self, params: dict) -> tuple[list, list]:
        """Each mLSTM and sLSTM block's tree, in stack order."""
        kinds = _xlstm_kinds(self.cfg)
        layers = params["layers"]
        return (unbind_layers(layers["mlstm"], kinds.count("mlstm")),
                unbind_layers(layers["slstm"], kinds.count("slstm"))
                if "slstm" in layers else [])

    def _xlstm_forward(self, params: dict, h: torch.Tensor,
                       par: common.Parallel | None) -> torch.Tensor:
        """The blocks in layer order, each under ``remat``."""
        xc = _xlstm_cfg(self.cfg)
        m_fn = _remat(lambda p, x: xlstm.mlstm_block(p, x, xc, par),
                      self.cfg)
        s_fn = _remat(lambda p, x: xlstm.slstm_block(p, x, xc,
                                                     par=par)[0], self.cfg)
        mlstm, slstm = self._xlstm_layers(params)
        for seg in _xlstm_segments(self.cfg):
            if seg[0] == "m":
                for p in mlstm[seg[1]:seg[2]]:
                    h = m_fn(p, h)
            else:
                h = s_fn(slstm[seg[1]], h)
        return h

    def forward(self, params: dict, batch: Batch,
                par: common.Parallel | None = None) -> torch.Tensor:
        """``batch`` -> ``(b, s, vocab)`` logits in the compute dtype over
        its ``s`` text (or embeds-in) positions (the reference's
        ``forward``, whose MoE auxiliary loss is not returned: ``loss``
        adds it). The VLM's image positions are cut before the
        unembedding, which the reference runs over them and then drops.
        Its products run in :func:`~repro_torch.pin_detector_matmul`'s
        scope: float32 ones in full float32, bf16 ones reduced in float32,
        as the reference's dots accumulate, whatever the caller's flags.

        With ``par``, ``params`` are this rank's blocks and the logits are
        this rank's block of the vocab (``par.group`` of the unembedding's
        ``"vocab"`` dim gathers them)."""
        with pin_detector_matmul():
            h, _ = self._trunk(params, batch, par)
            return common.unembed(params["unembed"], h, self.compute_dtype,
                                  par, self.cfg.vocab)

    #: the seq-chunked cross entropy kicks in above this sequence length
    _LOSS_CHUNK = 1024

    def loss(self, params: dict, batch: Batch,
             par: common.Parallel | None = None) -> torch.Tensor:
        """The masked NLL of ``batch.labels`` under the logits of
        ``batch`` (its text positions), a float32 0-d tensor: the
        reference's ``loss``.
        Each position's ``logsumexp - gold`` in float32, summed over the
        positions whose label is not -1 and divided by
        ``max(count, 1)``. The logsumexp is the reference's
        (``jax.nn.logsumexp``): the row's maximum, held constant,
        subtracted before ``exp`` and added back after ``log``. For a
        vocab of 8192 or more over a sequence of more than ``_LOSS_CHUNK``
        that it divides, the logits are made one chunk of positions at a
        time, each chunk under a checkpoint, so the float32 logits never
        live for the whole sequence. The experts' auxiliary loss, summed
        over the layers, is added to the quotient. The products run in
        :func:`~repro_torch.pin_detector_matmul`'s scope; a caller that
        runs the backward pass keeps it open across both, as
        :mod:`repro_torch.launch.steps`' train step does.

        With ``par``, ``params`` are this rank's blocks and ``batch`` its
        block of the batch. Over the vocab's group the logsumexp is
        vocab-parallel: the ranks' maxima gathered, ``exp`` summed over
        this rank's columns and folded, the gold logit taken by the rank
        whose block holds the label (zero elsewhere) and folded. The NLL
        sum and the label count are folded over the batch's group
        (``Parallel.batch_group``) before the division, so the loss is
        the whole batch's on every rank. A batch that group does not
        split runs whole on each of its ranks: both sums then count it
        once a rank, and their ratio is the batch's loss. The auxiliary
        loss is the whole batch's on every rank (its gradient this rank's
        share: :func:`~repro_torch.models.mlp.moe_apply`)."""
        cfg = self.cfg
        unembed = params["unembed"]
        vocab_group, lo = None, 0
        batch_group = None
        if par is not None:
            vocab_group = par.group(
                common.unembed_spec(cfg.vocab, cfg.d_model)["kernel"],
                "vocab")
            if vocab_group is not None:
                lo, _ = sharding.local_range(cfg.vocab, vocab_group)
            batch_group = par.batch_group()

        def chunk_nll(hc, lc):
            logits = common.unembed(unembed, hc, self.compute_dtype, par,
                                    cfg.vocab)
            logits = logits.to(torch.float32)
            mask = (lc >= 0).to(torch.float32)
            m = logits.detach().amax(dim=-1)
            idx = lc.to(torch.int64) - lo
            here = (idx >= 0) & (idx < logits.shape[-1])
            gold = torch.gather(logits, -1, torch.where(
                here, idx, 0)[..., None])[..., 0]
            gold = torch.where(here, gold, 0.0)
            if vocab_group is not None:
                m = sharding.max_over(m, vocab_group)
            z = torch.exp(logits - m[..., None]).sum(dim=-1)
            if vocab_group is not None:
                z = sharding.fold_partials(z, vocab_group)
                gold = sharding.fold_partials(gold, vocab_group)
            logz = torch.log(z) + m
            return ((logz - gold) * mask).sum(), mask.sum()

        with pin_detector_matmul():
            h, aux = self._trunk(params, batch, par)
            labels = batch.labels
            s, ch = h.shape[1], self._LOSS_CHUNK
            if s <= ch or s % ch or cfg.vocab < 8192:
                nll, cnt = chunk_nll(h, labels)
            else:
                nll = cnt = torch.zeros((), dtype=torch.float32,
                                        device=h.device)
                for lo_s in range(0, s, ch):
                    n, c = torch.utils.checkpoint.checkpoint(
                        chunk_nll, h[:, lo_s:lo_s + ch],
                        labels[:, lo_s:lo_s + ch],
                        use_reentrant=False, preserve_rng_state=False)
                    nll, cnt = nll + n, cnt + c
            if batch_group is not None:
                nll = sharding.fold_partials(nll, batch_group)
                cnt = sharding.fold_partials(cnt, batch_group)
            loss = nll / torch.clamp(cnt, min=1.0)
            return loss if aux is None else loss + aux

    # ----- decode -----

    def decode_state_spec(self, batch: int, max_seq: int) -> Any:
        """The decode state as meta tensors: for the transformer families
        one bf16 cache a layer, stacked, ``(n_layers, batch, max_seq, kv,
        head_dim)`` a leaf; for the hybrid ``{"mamba": SSMState, "attn":
        KVCache}``, each Mamba layer's float32 recurrent state and bf16
        convolution buffer and each shared-block call's bf16 cache,
        stacked; for the xLSTM a list of each block's state, whatever
        ``max_seq``."""
        cfg = self.cfg
        check_decodes(cfg)
        if cfg.family == "ssm":
            xc = _xlstm_cfg(cfg)
            return [xlstm.slstm_state_spec(xc, batch) if kind == "slstm"
                    else xlstm.mlstm_state_spec(xc, batch)
                    for kind in _xlstm_kinds(cfg)]

        def stacked(n, t):
            return torch.empty((n, *t.shape), dtype=t.dtype, device="meta")
        one = attention.cache_spec(_attn_cfg(cfg), batch, max_seq)
        if cfg.family != "hybrid":
            return attention.KVCache(*(stacked(cfg.n_layers, t)
                                       for t in one))
        n_inv = len(_hybrid_positions(cfg))
        return {"mamba": ssm.SSMState(*(
                    stacked(cfg.n_layers, t)
                    for t in ssm.state_spec(_ssm_cfg(cfg), batch))),
                "attn": attention.KVCache(*(stacked(n_inv, t)
                                            for t in one))}

    def init_decode_state(self, batch: int, max_seq: int,
                          device: str | torch.device | None = None) -> Any:
        """The decode state, zeros on ``device`` (``None`` -> CUDA, raising
        without it)."""
        dev = resolve_device(device)
        return map_state(
            lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
            self.decode_state_spec(batch, max_seq))

    def decode_step(self, params: dict, state: Any, batch: DecodeBatch,
                    par: common.Parallel | None = None,
                    state_spec: Any = None) -> tuple[torch.Tensor, Any]:
        """One token for the whole stack: ``(logits (b, 1, vocab) in the
        compute dtype, state)``, the state written in place at
        ``batch.index`` (the reference's ``decode_step`` under
        ``donate_argnums=(1,)``). No host sync: the index stays on the
        device. The products run in
        :func:`~repro_torch.pin_detector_matmul`'s scope, with no
        autograd. The hybrid needs a shared block (``shared_attn_every``):
        without one the reference's step fails, and so does this one
        (``ValueError``).

        With ``par``, ``params`` are this rank's blocks, ``state`` its
        block of the whole state under ``state_spec`` (the tree of each
        leaf's spec, the leading layer dim's included; a block's shape
        cannot say how it was cut), ``batch.tokens`` its block of the
        batch, and the logits its block of the vocab, as
        :meth:`forward`'s."""
        check_decodes(self.cfg)
        if par is not None and state_spec is None:
            raise ValueError("a sharded decode step needs the state's spec")
        cfg = self.cfg
        if cfg.family == "hybrid" and not _hybrid_positions(cfg):
            raise ValueError(f"{cfg.arch_id}: the hybrid decode step needs "
                             f"a shared block (shared_attn_every > 0)")
        with torch.no_grad(), pin_detector_matmul():
            h = common.embed(params["embed"], batch.tokens,
                             self.compute_dtype, par, cfg.vocab, cfg.d_model)
            if cfg.family == "hybrid":
                h = self._hybrid_decode(params, h, state, batch.index, par,
                                        state_spec)
            elif cfg.family == "ssm":
                h = self._xlstm_decode(params, h, state, par, state_spec)
            else:
                layer_spec = None if par is None else tuple(
                    state_spec.k[1:])
                for i, p in enumerate(unbind_layers(params["layers"],
                                                    cfg.n_layers)):
                    h, _ = _tf_layer_decode(
                        p, h, attention.KVCache(state.k[i], state.v[i]),
                        batch.index, cfg, par, layer_spec)
            h = common.apply_norm(h, params.get("final_norm"), cfg.norm)
            logits = common.unembed(params["unembed"], h,
                                    self.compute_dtype, par, cfg.vocab)
        return logits, state

    def _hybrid_decode(self, params: dict, h: torch.Tensor, state: dict,
                       index: torch.Tensor, par: common.Parallel | None,
                       state_spec: dict | None) -> torch.Tensor:
        """Each Mamba layer's step against its state, the shared block
        after each full group against its call's cache, in place."""
        cfg = self.cfg
        scfg, acfg, mcfg = _ssm_cfg(cfg), _attn_cfg(cfg), _mlp_cfg(cfg)
        m_spec = a_spec = None
        if par is not None:
            m_spec = ssm.SSMState(*(tuple(t[1:])
                                    for t in state_spec["mamba"]))
            a_spec = tuple(state_spec["attn"].k[1:])
        shared_at = _hybrid_positions(cfg)
        p = params["shared_attn"]
        h0 = h
        inv = 0
        for i, lp in enumerate(unbind_layers(params["layers"],
                                             cfg.n_layers)):
            st = ssm.SSMState(state["mamba"].ssm[i], state["mamba"].conv[i])
            h = h + ssm.decode_step(lp, h, st, scfg, par, m_spec)
            if i in shared_at:
                a = common.apply_norm(_injected(p, h, h0, cfg, par),
                                      p["attn_norm"], cfg.norm)
                cache = attention.KVCache(state["attn"].k[inv],
                                          state["attn"].v[inv])
                attn_out, _ = attention.decode_step(p["attn"], a, cache,
                                                    index, acfg, par, a_spec)
                h = h + attn_out
                m = common.apply_norm(h, p["mlp_norm"], cfg.norm)
                h = h + mlp.apply(p["mlp"], m, mcfg, par=par)
                inv += 1
        return h

    def _xlstm_decode(self, params: dict, h: torch.Tensor, state: list,
                      par: common.Parallel | None,
                      state_spec: list | None) -> torch.Tensor:
        """Each block's step against its state, in layer order, in
        place."""
        xc = _xlstm_cfg(self.cfg)
        mlstm, slstm = self._xlstm_layers(params)
        m_i = s_i = 0
        for i, (kind, st) in enumerate(zip(_xlstm_kinds(self.cfg), state,
                                           strict=True)):
            spec = None if state_spec is None else state_spec[i]
            if kind == "slstm":
                h, _ = xlstm.slstm_block_step(slstm[s_i], h, st, xc, par,
                                              spec)
                s_i += 1
            else:
                h, _ = xlstm.mlstm_block_step(mlstm[m_i], h, st, xc, par,
                                              spec)
                m_i += 1
        return h
