"""The production train loop on PyTorch: gradient accumulation,
checkpoint and restart, preemption. The twin of ``repro.train.loop``.

Fault-tolerance contract:

* a checkpoint every ``ckpt_every`` steps, written on a background thread
  (:class:`~repro_torch.ckpt.checkpoint.AsyncCheckpointer`), and one at
  the end of the step a SIGTERM came in (the preemption save) before the
  process exits with 143;
* a relaunch resumes from the latest complete checkpoint, parameters and
  AdamW state, and the data stream with it: a batch is a function of its
  step alone (:func:`synthetic_lm_data`), so every batch is trained on
  exactly once across restarts, and a resumed run is bitwise an
  uninterrupted one;
* elastic: over a ``torch.distributed`` mesh (``train(mesh=)``, the
  counterpart of the reference's ``jit_kwargs``, the train cell's
  shardings) each rank steps its blocks of the state, the checkpoint is
  written whole by rank 0 and a relaunch cuts its blocks from it, so it
  may take another mesh, or none.

The port's step runs eagerly. Every metric stays on the device until a
log step reads it, so a step between log steps makes no host sync; on a
mesh the ranks agree on a preemption once a step over a ``gloo`` group,
on the host.
"""

from __future__ import annotations

import itertools
import math
import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from repro_torch import pin_detector_matmul, resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.models import common, lm
from repro_torch.train import optim

#: the stream's base seed; a step's batch is drawn from a generator seeded
#: ``DATA_SEED * 2**32 + step``
DATA_SEED = 1234


@dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1          # grad accumulation factor
    ckpt_every: int = 50
    # the reference's /tmp/repro_ckpt, under TMPDIR where one is set
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    keep: int = 3
    log_every: int = 10
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1


def loss_and_grads(model: lm.Model, params, batch: lm.Batch,
                   par: common.Parallel | None = None, folds=None):
    """``(loss, grads)`` of ``model.loss`` with respect to ``params`` as
    they are (the float32 masters: each product casts its weight to the
    compute dtype, and the gradients come back in float32); the loss and
    the backward pass in one :func:`~repro_torch.pin_detector_matmul`
    scope, where every remat recompute runs too.

    With ``par``, ``params`` and ``batch`` are this rank's blocks and so
    are the gradients; the loss is the whole batch's. ``folds`` are
    ``par``'s groups for the parameters (the first of :meth:`~repro_torch.
    models.common.Parallel.grad_groups`): a gradient whose parameter's
    spec does not split it over the batch's mesh dims holds this rank's
    batch block's share there, and is folded over its group in rank
    order, as the sharded train cell's are."""
    with torch.enable_grad():
        ps = common.tree_map(lambda p: p.detach().requires_grad_(), params)
        with pin_detector_matmul():
            loss = model.loss(ps, batch, par)
            flat = torch.autograd.grad(loss, common.leaves(ps))
    if folds is not None:
        with torch.no_grad():
            flat = [g if grp is None else sharding.fold_partials(g, grp)
                    for g, grp in zip(flat, folds)]
    flat = iter(flat)
    return loss.detach(), common.tree_map(lambda _: next(flat), params)


def make_train_step(model: lm.Model, opt: optim.AdamW,
                    microbatches: int = 1,
                    par: common.Parallel | None = None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    ``metrics`` ``{"loss", "grad_norm"}`` as 0-d float32 tensors on the
    device.

    With ``microbatches > 1`` the leading dim of every field of the batch
    is cut into ``microbatches`` equal parts, and their gradients are
    added into float32 zeros in order; the loss is the mean of the parts'
    losses and each gradient their sum over ``microbatches``, as the
    reference's ``lax.scan``. ``grad_norm`` is the norm of the averaged
    gradients, before AdamW clips them.

    With ``par`` (its ``batch`` the sequences of one microbatch, the
    whole mesh's), ``params``, ``opt_state`` and ``batch`` are this
    rank's blocks, and so are the results: the rank's block of the batch
    is cut into the microbatches, each gradient folded over the batch's
    mesh dims its spec leaves whole (:func:`loss_and_grads`), the norm
    and the clip folded over each leaf's groups (:func:`~repro_torch.
    train.optim.global_norm`); ``loss`` and ``grad_norm`` are the same on
    every rank."""
    folds, norm_groups = ((None, None) if par is None
                          else par.grad_groups(model.spec()))

    def step(params, opt_state, batch: lm.Batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch, par, folds)
        else:
            def part(x, i):
                if x is None:
                    return None
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"a batch (block) of {b} sequences "
                                     f"does not cut into {microbatches} "
                                     f"microbatches")
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])[i]

            loss = torch.zeros((), dtype=torch.float32,
                               device=common.leaves(params)[0].device)
            grads = common.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for i in range(microbatches):
                li, gi = loss_and_grads(
                    model, params, lm.Batch(*(part(x, i) for x in batch)),
                    par, folds)
                loss = loss + li
                gs = iter(common.leaves(gi))
                grads = common.tree_map(lambda g: g + next(gs), grads)
            loss = common.true_divide(loss, microbatches)
            grads = common.tree_map(
                lambda g: common.true_divide(g, microbatches), grads)
        with torch.no_grad():
            gnorm = optim.global_norm(grads, norm_groups)
            updates, opt_state = opt.update(grads, opt_state, params,
                                            norm_groups)
            params = optim.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def train(model: lm.Model, data: Iterator[lm.Batch], tc: TrainConfig, *,
          params=None, on_metrics: Callable[[int, dict], None] | None = None,
          device: str | torch.device | None = None, mesh=None) -> dict:
    """Run (or resume) training: ``{params, opt_state, step, history}``.

    AdamW on ``warmup_cosine(tc.lr, tc.warmup, tc.steps)``; ``params=None``
    draws ``model.init`` from a generator seeded 0 on ``device`` (``None``
    -> CUDA, raising without it). With a checkpoint in ``tc.ckpt_dir``
    the parameters and AdamW state are restored onto ``device`` and the
    loop goes on from its step; ``data`` must then start at that step
    (``synthetic_lm_data(..., start_step=)``). A checkpoint every
    ``tc.ckpt_every`` steps (written in the background) and a last one,
    written before returning. SIGTERM (its handler installed for the
    loop's run and the caller's put back after it) only marks the
    process: at the end of the step it came in, the preemption checkpoint
    is written, the write in flight finished first, and the loop raises
    ``SystemExit(143)`` once it is on disk. The loss is read back to the
    host on a log step alone (every ``tc.log_every`` steps and the
    first), where it is printed and handed to ``on_metrics``.

    With ``mesh`` (a named ``("data", "model")`` ``DeviceMesh``, or with
    "pod"; every rank of it calls ``train`` with the same arguments)
    the step is the sharded train cell's layout under the current rules
    (:func:`make_train_step` with ``par``): ``params`` (or
    ``model.init``, drawn alike on every rank) and each batch of ``data``
    are whole, the same on every rank, and each rank keeps its blocks
    (the batch's rows arranged so that every microbatch is the unsharded
    loop's, :func:`microbatch_rows`), so the stream and its microbatches
    are the unsharded ones on any mesh. A resume cuts the blocks from the
    whole checkpoint (``ckpt.restore(specs=, mesh=)``), whatever mesh
    wrote it. Checkpoints are gathered whole and written by rank 0
    (:class:`~repro_torch.ckpt.checkpoint.MeshCheckpointer`). At each
    step's end the ranks agree on the marks (:func:`agree`), so a signal
    to any rank, or to several at other steps, stops every rank on the
    same step, at most one step later: every rank joins the gather, rank
    0 writes, and every rank raises ``SystemExit(143)`` once the
    checkpoint is on disk. ``loss`` and ``grad_norm`` are the same on
    every rank; ``on_metrics`` is called on every rank, rank 0 alone
    prints. The result holds this rank's blocks."""
    dev = resolve_device(device)
    opt = optim.AdamW(lr=optim.warmup_cosine(tc.lr, tc.warmup, tc.steps),
                      weight_decay=tc.weight_decay)
    rank0 = mesh is None or dist.get_rank() == 0
    group = state_specs = par = None

    def place(batch):
        return batch
    if mesh is not None:
        group = control_group(mesh)
        first = next(data)
        data = itertools.chain([first], data)
        b, s = first.labels.shape
        rules = sharding.current_rules()
        cell = steps.build_train_cell(
            model.cfg, ShapeConfig("loop", s, b, "train"), mesh, rules)
        state_specs, batch_specs = cell.in_shardings[:2], cell.in_shardings[2]
        arrange = microbatch_rows(batch_specs.labels[0], mesh, b,
                                  tc.microbatches)
        par = common.Parallel(mesh, rules, b // tc.microbatches)

        def place(batch):
            return steps.local_args(lm.Batch(*map(arrange, batch)),
                                    batch_specs, mesh)

    start_step = 0
    latest = ckpt.latest_step(tc.ckpt_dir)
    if latest is None:
        if params is None:
            params = model.init(torch.Generator(device=dev).manual_seed(0))
        if mesh is not None:
            params = steps.local_args(params, state_specs[0], mesh)
        opt_state = opt.init(params)
    else:
        like = model.abstract_params()
        (params, opt_state), extra = ckpt.restore(
            tc.ckpt_dir, (like, opt.init(like)), device=dev,
            specs=state_specs, mesh=mesh)
        start_step = extra.get("step", latest)
        if rank0:
            print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = make_train_step(model, opt, tc.microbatches, par)
    saver = ckpt.MeshCheckpointer(tc.ckpt_dir, tc.keep, state_specs, mesh,
                                  group)
    marked = []
    before = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda signum, frame: marked.append(signum))
    try:
        t0 = time.time()
        history = []
        for step_i in range(start_step, tc.steps):
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 place(next(data)))
            if (step_i + 1) % tc.log_every == 0 or step_i == start_step:
                loss = float(metrics["loss"])
                history.append(loss)
                if rank0:
                    print(f"[train] step {step_i + 1}/{tc.steps} loss "
                          f"{loss:.4f} gnorm "
                          f"{float(metrics['grad_norm']):.3f} "
                          f"({time.time() - t0:.1f}s)", flush=True)
                if on_metrics:
                    on_metrics(step_i + 1,
                               {k: float(v) for k, v in metrics.items()})
            if agree(bool(marked), group):
                saver.save_now(step_i + 1, (params, opt_state),
                               extra={"step": step_i + 1})
                if rank0:
                    print(f"[train] preemption checkpoint at step "
                          f"{step_i + 1}", flush=True)
                raise SystemExit(128 + signal.SIGTERM)
            if (step_i + 1) % tc.ckpt_every == 0:
                saver.save(step_i + 1, (params, opt_state),
                           extra={"step": step_i + 1})
        saver.save_now(tc.steps, (params, opt_state),
                       extra={"step": tc.steps})
    finally:
        signal.signal(signal.SIGTERM, before)
    return {"params": params, "opt_state": opt_state,
            "step": tc.steps, "history": history}


def control_group(mesh):
    """A ``gloo`` process group of ``mesh``'s ranks, made the first time
    the mesh is asked for it (every rank of the world asks at once) and
    kept by the mesh: the loop's agreements and barriers, which wait on
    the host and never on a card."""
    cache = mesh.__dict__
    if "_control_group" not in cache:
        cache["_control_group"] = dist.new_group(
            sorted(mesh.mesh.flatten().tolist()), backend="gloo")
    return cache["_control_group"]


def agree(marked: bool, group) -> bool:
    """Whether any rank of ``group`` is ``marked``, on every rank alike: a
    one-int maximum over the ``gloo`` group, on the host (no CUDA sync);
    ``marked`` itself where ``group`` is None (one process)."""
    if group is None:
        return marked
    flag = torch.tensor([int(marked)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag[0])


def microbatch_rows(spec, mesh, b: int, microbatches: int) -> Callable:
    """The row order of a whole batch of ``b`` sequences, split over the
    mesh dims ``spec`` names (its batch dim's entry), in which each rank's
    block, cut into ``microbatches`` parts, holds that rank's share of
    each of the unsharded step's microbatches in turn: microbatch ``i``
    is rows ``[i b/m, (i+1) b/m)`` of the stream on every mesh, as the
    reference's global batch under its shardings. The identity where the
    batch is not split or not cut."""
    axes = () if spec is None else (spec,) if isinstance(spec, str) else spec
    k = math.prod(sharding.mesh_shape(mesh)[a] for a in axes)
    if k == 1 or microbatches == 1:
        return lambda x: x
    if b % (k * microbatches):
        raise ValueError(f"a batch of {b} sequences does not cut into "
                         f"{microbatches} microbatches on {k} ranks")

    def arrange(x):
        if x is None:
            return None
        return x.reshape(microbatches, k, b // (k * microbatches),
                         *x.shape[1:]).transpose(0, 1).reshape(x.shape)
    return arrange


def _step_generator(step: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        DATA_SEED * 2 ** 32 + step)


def synthetic_lm_data(cfg, batch: int, seq: int, start_step: int = 0,
                      device: str | torch.device | None = None
                      ) -> Iterator[lm.Batch]:
    """A deterministic synthetic LM stream keyed by step, drawn on
    ``device`` (``None`` -> CUDA, raising without it): step ``k``'s batch
    comes from a generator seeded from ``DATA_SEED`` and ``k`` alone, so a
    stream started at ``k`` gives the batches an uninterrupted one gives
    from ``k`` on (exactly once across restarts). The reference's
    layouts: int32 tokens in ``[0, vocab)`` with their labels the tokens
    rolled left by one; an embeds-in config's float32 ``(batch, seq,
    d_model)`` normal embeddings and int32 labels, no tokens; the VLM's
    float32 ``(batch, n_image_tokens, d_model)`` normal image prefix. The
    bits are the generator's, not ``jax.random``'s."""
    dev = resolve_device(device)
    step = start_step
    while True:
        g = _step_generator(step, dev)
        if cfg.embeds_in:
            embeds = torch.randn((batch, seq, cfg.d_model), generator=g,
                                 device=dev)
            labels = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                                   device=dev, dtype=torch.int32)
            yield lm.Batch(tokens=None, labels=labels, embeds=embeds)
        else:
            tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                                   device=dev, dtype=torch.int32)
            labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
            embeds = None
            if cfg.family == "vlm":
                embeds = torch.randn((batch, cfg.n_image_tokens,
                                      cfg.d_model), generator=g, device=dev)
            yield lm.Batch(tokens=tokens, labels=labels, embeds=embeds)
        step += 1
