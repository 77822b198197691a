"""The detector cell on PyTorch: the gated cascade's downstream step.

The twin of ``repro.launch.steps``' detector cell (``detector_seq_len``,
``build_detector_cell`` with its ``mesh=``, ``init_detector_params``). The
train, prefill and decode cells come with the LM zoo (``ROADMAP.md`` §1
item 4).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import pin_detector_matmul
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import common, lm


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
        last = model.forward(weights["backbone"], emb[None].to(dt),
                             par)[0, -1]
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
