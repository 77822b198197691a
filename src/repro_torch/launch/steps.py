"""Step builders and input specs on PyTorch: the train, prefill and decode
cells and the detector cell of the gated cascade.

The twin of ``repro.launch.steps``: ``input_specs(cfg, shape)`` gives
meta-tensor stand-ins for every input of a cell's step (no allocation);
``build_cell(cfg, shape, mesh)`` gives a :class:`Cell` with the step, the
spec trees of its inputs and outputs on ``mesh`` (each a
:func:`~repro_torch.distributed.sharding.logical_sharding` tuple, None
without a mesh) and its abstract arguments. Cells:

* train — the full step: the loss, its gradients, the AdamW update;
* prefill — the logits over the whole sequence;
* decode — one token against a pre-filled KV cache (the hybrid's:
  its Mamba layers' SSM states and convolution buffers and its shared
  block's caches; the xLSTM's: each block's recurrent state)
  (``serve_step(params, state, batch) -> (next tokens,
  state)``, the argmax of the last logits, the state written in place
  as the reference donates it);
* detector — a fixed batch of frames through an embeds-in backbone, the
  gated cascade's downstream step (``build_detector_cell``, with its
  ``mesh=``, ``init_detector_params``).

With a mesh (a named ``DeviceMesh``; every rank builds the cell and runs
every step together) the train, prefill and decode steps take this
rank's blocks, those ``in_shardings`` describes, and return the blocks
``out_shardings`` describes (the decode cell's cache split by kv heads,
or along the sequence where "model" does not divide them, the hybrid's
SSM states by SSM heads and its convolution buffers whole, the xLSTM's
states by heads and its convolution buffers whole, its next
tokens the argmax of the vocab blocks gathered): the forward written
out over the mesh (:class:`~repro_torch.models.common.Parallel`), the loss vocab-parallel
and folded over the batch's group, the gradients through collectives
that autograd differentiates (:mod:`repro_torch.distributed.sharding`),
the clip's norm folded over each leaf's groups, AdamW on the blocks.
:func:`local_args` cuts a whole ``(params, opt_state, batch)`` into a
rank's arguments and :func:`whole_args` puts blocks back together. A
cell built with a ``{name: size}`` mapping carries its spec trees for
counting; its step needs a ``DeviceMesh``. A token batch is cut over
the batch's mesh dims like an embeds-in one, and so is the VLM's image
prefix.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import pin_detector_matmul
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.models import attention, common, lm, ssm, xlstm
from repro_torch.models.lm import Batch, DecodeBatch
from repro_torch.train import optim


class Cell(NamedTuple):
    step_fn: Callable
    in_shardings: Any
    out_shardings: Any
    abstract_args: tuple
    donate_argnums: tuple


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Batch:
    """The cell's batch: int32 labels; int32 tokens, or for an embeds-in
    config bf16 ``(b, s, d_model)`` embeddings; the VLM's bf16 ``(b,
    n_image_tokens, d_model)`` image prefix beside its tokens."""
    b, s = shape.global_batch, shape.seq_len
    tokens = None if cfg.embeds_in else _meta((b, s), torch.int32)
    embeds = None
    if cfg.embeds_in:
        embeds = _meta((b, s, cfg.d_model), torch.bfloat16)
    elif cfg.family == "vlm":
        embeds = _meta((b, cfg.n_image_tokens, cfg.d_model), torch.bfloat16)
    return Batch(tokens=tokens, labels=_meta((b, s), torch.int32),
                 embeds=embeds)


def _batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     rules=None) -> Batch:
    def sh(t, axes):
        if t is None:
            return None
        return sharding.logical_sharding(t.shape, axes, mesh, rules)

    specs = _batch_specs(cfg, shape)
    return Batch(
        tokens=sh(specs.tokens, ("act_batch", "act_seq")),
        labels=sh(specs.labels, ("act_batch", "act_seq")),
        embeds=sh(specs.embeds, ("act_batch", "act_seq", "act_embed")),
    )


def _abstract_opt_state(p_abs: dict) -> optim.AdamWState:
    return optim.AdamWState(
        step=_meta((), torch.int32),
        mu=common.tree_map(lambda t: _meta(t.shape, t.dtype), p_abs),
        nu=common.tree_map(lambda t: _meta(t.shape, t.dtype), p_abs))


def local_args(args, specs, mesh):
    """This rank's blocks of ``args`` (whole tensors, the same on every
    rank) under ``specs``, a cell's ``in_shardings`` or ``out_shardings``
    of the same structure (:func:`~repro_torch.distributed.sharding.
    local_block` at each tensor). On meta tensors it allocates nothing."""
    return sharding.map_blocks(sharding.local_block, args, specs, mesh)


def whole_args(blocks, specs, mesh):
    """The inverse of :func:`local_args`: every block gathered whole
    (:func:`~repro_torch.distributed.sharding.whole_block`), the same on
    every rank."""
    return sharding.map_blocks(sharding.whole_block, blocks, specs, mesh)


# ---------------------------------------------------------------------------
# Cell builders
# ---------------------------------------------------------------------------

def make_optimizer(cfg: ModelConfig) -> optim.AdamW:
    return optim.AdamW(lr=optim.warmup_cosine(3e-4, 2000, 100_000),
                       weight_decay=0.1)


def loss_and_grads(model: lm.Model, params: dict, batch: Batch,
                   par: common.Parallel | None = None):
    """``(loss, grads)`` of ``model.loss`` at ``params``: the float32
    master weights cast to the compute dtype once, the gradients taken
    with respect to that cast tree (in bf16 for a bf16 config, as the
    reference's ``value_and_grad`` on ``cast_params``). The loss and its
    backward pass run in one :func:`~repro_torch.pin_detector_matmul`
    scope, since autograd runs the backward pass (and each remat layer's
    recompute) under the flags set when it runs. ``loss`` is a float32
    0-d tensor, never read back to the host here.

    With ``par``, ``params`` and ``batch`` are this rank's blocks and so
    are the gradients. A leaf that its spec does not split over the
    batch's mesh dims (a norm's scale and bias, for one) holds this
    rank's batch block's share of its gradient: it is folded over those
    dims, in rank order. An FSDP leaf already has that sum from its
    gather's backward pass."""
    dt = model.compute_dtype

    def cast(p: torch.Tensor) -> torch.Tensor:
        c = p.detach().to(dt) if p.dtype == torch.float32 else p.detach()
        return c.requires_grad_()

    cast_params = common.tree_map(cast, params)
    with pin_detector_matmul():
        loss = model.loss(cast_params, batch, par)
        flat = torch.autograd.grad(loss, common.leaves(cast_params))
    if par is not None:
        folds, _ = par.grad_groups(model.spec())
        with torch.no_grad():
            flat = [g if grp is None else sharding.fold_partials(g, grp)
                    for g, grp in zip(flat, folds)]
    flat = iter(flat)
    return loss.detach(), common.tree_map(lambda _: next(flat), cast_params)


def train_step_fn(model: lm.Model, opt: optim.AdamW,
                  par: common.Parallel | None = None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    :func:`loss_and_grads`, then ``opt.update`` with float32 moments and
    ``apply_updates``; with ``par``, on this rank's blocks, the clip's
    norm folded over each leaf's groups."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, par)
        norm_groups = None if par is None else par.grad_groups(
            model.spec())[1]
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params,
                                            norm_groups)
            params = optim.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                     rules=None) -> Cell:
    model = lm.Model(cfg)
    p_abs = model.abstract_params()
    opt_abs = _abstract_opt_state(p_abs)
    b_abs = _batch_specs(cfg, shape)
    in_sh = out_sh = par = None
    if mesh is not None:
        # the rules resolved once, so the step reads the blocks the spec
        # trees describe, whatever use_mesh scope it runs in
        rules = rules or sharding.current_rules()
        par = common.Parallel(mesh, rules, shape.global_batch)
        p_sh = model.param_specs(mesh, rules)
        opt_sh = optim.AdamWState(step=(), mu=p_sh, nu=p_sh)
        in_sh = (p_sh, opt_sh, _batch_shardings(cfg, shape, mesh, rules))
        out_sh = (p_sh, opt_sh, ())
    return Cell(
        step_fn=train_step_fn(model, make_optimizer(cfg), par),
        in_shardings=in_sh,
        out_shardings=out_sh,
        abstract_args=(p_abs, opt_abs, b_abs),
        donate_argnums=(0, 1),
    )


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                       rules=None) -> Cell:
    model = lm.Model(cfg)
    in_sh = out_sh = par = None
    if mesh is not None:
        rules = rules or sharding.current_rules()
        par = common.Parallel(mesh, rules, shape.global_batch)
        out_shape = (shape.global_batch, shape.seq_len, cfg.vocab)
        in_sh = (model.param_specs(mesh, rules),
                 _batch_shardings(cfg, shape, mesh, rules))
        out_sh = sharding.logical_sharding(
            out_shape, ("act_batch", "act_seq", "act_vocab"), mesh, rules)

    def prefill_step(params, batch):
        return model.forward(params, batch, par)

    return Cell(
        step_fn=prefill_step,
        in_shardings=in_sh,
        out_shardings=out_sh,
        abstract_args=(model.abstract_params(), _batch_specs(cfg, shape)),
        donate_argnums=(),
    )


def _decode_state_axes(model: lm.Model) -> Any:
    """The logical axes of ``decode_state_spec``'s leaves (a stacked
    state's leading layer dim included), in the same tree: the KV cache of the dense,
    moe and vlm families; the hybrid's Mamba states and shared-block
    caches; the xLSTM's list of per-block states."""
    lm.check_decodes(model.cfg)
    if model.cfg.family == "ssm":
        return [xlstm.slstm_state_axes() if kind == "slstm"
                else xlstm.mlstm_state_axes()
                for kind in lm._xlstm_kinds(model.cfg)]
    ax = attention.cache_axes()
    cache = attention.KVCache(("layers", *ax.k), ("layers", *ax.v))
    if model.cfg.family != "hybrid":
        return cache
    sax = ssm.state_axes()
    return {"mamba": ssm.SSMState(("layers", *sax.ssm),
                                  ("layers", *sax.conv)),
            "attn": cache}


def _state_shardings(model: lm.Model, st_abs, mesh, rules):
    """The spec of every leaf of the decode state ``st_abs`` on
    ``mesh``, in its tree."""
    def one(t, axes):
        if isinstance(axes, dict):
            return {k: one(t[k], axes[k]) for k in axes}
        if isinstance(axes, list):
            return [one(a, b) for a, b in zip(t, axes, strict=True)]
        if isinstance(t, torch.Tensor):
            return sharding.logical_sharding(t.shape, axes, mesh, rules)
        return type(t)(*(one(a, b) for a, b in zip(t, axes)))
    return one(st_abs, _decode_state_axes(model))


def _decode_batch_specs(shape: ShapeConfig) -> DecodeBatch:
    return DecodeBatch(tokens=_meta((shape.global_batch, 1), torch.int32),
                       index=_meta((), torch.int32))


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                      rules=None) -> Cell:
    """``serve_step(params, state, batch) -> (next tokens (b,) int32,
    state)``: ``Model.decode_step``, then the argmax of the last logits;
    the state (``decode_state_spec`` at the shape's batch and sequence)
    written in place. With a mesh, each rank's blocks in and out, the
    vocab blocks of the logits gathered before the argmax, so every rank
    of the vocab's group picks the same tokens."""
    model = lm.Model(cfg)
    b = shape.global_batch
    st_abs = model.decode_state_spec(batch=b, max_seq=shape.seq_len)
    in_sh = out_sh = par = st_sh = None
    if mesh is not None:
        rules = rules or sharding.current_rules()
        par = common.Parallel(mesh, rules, shape.global_batch)
        st_sh = _state_shardings(model, st_abs, mesh, rules)
        db_sh = DecodeBatch(
            tokens=sharding.logical_sharding((b, 1), ("act_batch", None),
                                             mesh, rules),
            index=())
        tok_sh = sharding.logical_sharding((b,), ("act_batch",), mesh,
                                           rules)
        in_sh = (model.param_specs(mesh, rules), st_sh, db_sh)
        out_sh = (tok_sh, st_sh)

    def serve_step(params, state, batch):
        logits, state = model.decode_step(params, state, batch, par, st_sh)
        last = logits[:, -1, :]
        vocab_group = None if par is None else par.group(
            common.unembed_spec(cfg.vocab, cfg.d_model)["kernel"], "vocab")
        if vocab_group is not None:
            last = sharding.all_gather_cat(last, vocab_group, dim=-1)
        return torch.argmax(last, dim=-1).to(torch.int32), state

    return Cell(
        step_fn=serve_step,
        in_shardings=in_sh,
        out_shardings=out_sh,
        abstract_args=(model.abstract_params(), st_abs,
                       _decode_batch_specs(shape)),
        donate_argnums=(1,),
    )


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
               rules=None) -> Cell:
    builder = {"train": build_train_cell,
               "prefill": build_prefill_cell,
               "decode": build_decode_cell}[shape.kind]
    return builder(cfg, shape, mesh, rules)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """Meta-tensor stand-ins for every step input (no allocation)."""
    model = lm.Model(cfg)
    p_abs = model.abstract_params()
    if shape.kind == "train":
        return (p_abs, _abstract_opt_state(p_abs), _batch_specs(cfg, shape))
    if shape.kind == "prefill":
        return (p_abs, _batch_specs(cfg, shape))
    return (p_abs, model.decode_state_spec(batch=shape.global_batch,
                                           max_seq=shape.seq_len),
            _decode_batch_specs(shape))


class DetectorCell(NamedTuple):
    """``step_fn(weights, frames)``: a fixed ``(batch, H, W)`` float32 block
    of frames -> ``(batch, n_out)`` float32 logits, with ``weights =
    prepare(params)`` made once from :func:`init_detector_params`-shaped
    parameters (on a mesh: this rank's blocks of them)."""
    step_fn: Callable
    prepare: Callable


def detector_seq_len(frame_hw: tuple[int, int], patch: int) -> int:
    """Patch-token sequence length a detector frame unrolls to."""
    H, W = frame_hw
    if patch < 1 or H % patch or W % patch:
        raise ValueError(f"patch {patch} must divide frame {frame_hw}")
    return (H // patch) * (W // patch)


def build_detector_cell(cfg: ModelConfig, *, batch: int,
                        frame_hw: tuple[int, int], patch: int,
                        n_out: int = 2, mesh=None,
                        rules: dict | None = None) -> DetectorCell:
    """Downstream-backbone detector step for the gated cascade.

    Each frame is patchified to ``seq = (H/patch)*(W/patch)`` tokens,
    embedded in float32 (``embedder``: ``proj (patch², d_model)`` +
    ``pos (seq, d_model)``), run through the embeds-in backbone
    (``backbone``), and the last position's first ``n_out`` logits are its
    detection head, in float32.

    The step runs one per-frame program per row of the block, as the
    reference maps its batch with ``jax.lax.map``: every row runs the same
    products at the same shapes, so a frame's logits do not depend on its
    batch position or on its neighbours (zero pad rows included). One
    product over all rows would not do: the library picks its kernel and
    split by the row count.

    ``prepare`` makes the compute-dtype copy of the backbone once; the
    reference casts at every use, and the cast is deterministic, so the
    bits are the same.

    With a ``mesh`` (a ``("data", "model")`` ``DeviceMesh``; every rank
    builds the cell and runs every step together) the backbone is sharded
    by :meth:`~repro_torch.models.lm.Model.param_specs` (``rules`` over
    the default rules), as the reference's ``param_shardings``:
    ``prepare`` takes the whole parameters, the same on every rank, and
    keeps this rank's compute-dtype blocks; the step runs the sharded
    forward (:class:`~repro_torch.models.common.Parallel`), and the
    detection head's logits are gathered over the vocab's group in rank
    order. Frames and the embedder are replicated, so every rank returns
    the same logits, bitwise.
    """
    if not cfg.embeds_in:
        raise ValueError(f"{cfg.arch_id}: detector backbone needs an "
                         "embeds-in config (the patch embedder replaces "
                         "the token embedding)")
    if n_out < 1 or n_out > cfg.vocab:
        raise ValueError(f"n_out {n_out} must be in [1, vocab={cfg.vocab}]")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    model = lm.Model(cfg)
    H, W = frame_hw
    seq = detector_seq_len(frame_hw, patch)
    dt = model.compute_dtype
    # the rules resolved once, so the blocks prepare cuts are those the
    # step reads, whatever use_mesh scope each runs in
    rules = rules or sharding.current_rules()
    par = None if mesh is None else common.Parallel(mesh, rules)
    vocab_group = None if par is None else par.group(
        common.unembed_spec(cfg.vocab, cfg.d_model)["kernel"], "vocab")

    def prepare(params: dict) -> dict:
        backbone = common.tree_map(lambda a: a.to(dt), params["backbone"])
        if mesh is not None:
            backbone = common.local_params(
                backbone, model.param_specs(mesh, rules), mesh)
        return {"backbone": backbone,
                "embedder": {k: v.to(torch.float32)
                             for k, v in params["embedder"].items()}}

    def one_frame(weights: dict, frame: torch.Tensor) -> torch.Tensor:
        p = frame.reshape(H // patch, patch, W // patch, patch)
        p = p.permute(0, 2, 1, 3).reshape(seq, patch * patch)
        emb = (p.to(torch.float32) @ weights["embedder"]["proj"]
               + weights["embedder"]["pos"])
        last = model.forward(weights["backbone"], Batch(
            tokens=None, labels=None, embeds=emb[None].to(dt)), par)[0, -1]
        if vocab_group is not None:
            last = sharding.all_gather_cat(last, vocab_group)
        return last[:n_out].to(torch.float32)

    def detector_step(weights: dict, frames: torch.Tensor) -> torch.Tensor:
        # the scope covers a CUDA graph's capture of the step too
        with pin_detector_matmul():
            return torch.stack([one_frame(weights, f)
                                for f in frames.unbind(0)])

    return DetectorCell(step_fn=detector_step, prepare=prepare)


def init_detector_params(generator: torch.Generator, cfg: ModelConfig, *,
                         frame_hw: tuple[int, int], patch: int) -> dict:
    """Random detector parameters matching :func:`build_detector_cell`, in
    float32, drawn on the generator's device: the backbone's
    (``Model.init``), then ``proj ~ N(0, 1) / patch`` and
    ``pos ~ 0.02 N(0, 1)``."""
    model = lm.Model(cfg)
    seq = detector_seq_len(frame_hw, patch)
    dev = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    backbone = model.init(generator)
    return {
        "backbone": backbone,
        "embedder": {
            "proj": (1.0 / float(patch)) * normal((patch * patch,
                                                   cfg.d_model)),
            "pos": 0.02 * normal((seq, cfg.d_model)),
        },
    }
