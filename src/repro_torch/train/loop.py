"""The production train loop on PyTorch: gradient accumulation,
checkpoint and restart, preemption. The twin of ``repro.train.loop``.

Fault-tolerance contract:

* a checkpoint every ``ckpt_every`` steps, written on a background thread
  (:class:`~repro_torch.ckpt.checkpoint.AsyncCheckpointer`), and one on
  SIGTERM (the preemption save) before the process exits with 143;
* a relaunch resumes from the latest complete checkpoint, parameters and
  AdamW state, and the data stream with it: a batch is a function of its
  step alone (:func:`synthetic_lm_data`), so every batch is trained on
  exactly once across restarts, and a resumed run is bitwise an
  uninterrupted one.

The loop runs on one device. The reference's ``jit_kwargs`` (its
shardings) and the elastic restore onto a new mesh are not here: the
port's step runs eagerly, and the loop over a mesh is a later slice
(``ROADMAP.md`` §1). Every metric stays on the device until a log step
reads it, so a step between log steps makes no host sync.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import torch

from repro_torch import pin_detector_matmul, resolve_device
from repro_torch.ckpt import checkpoint as ckpt
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


def loss_and_grads(model: lm.Model, params, batch: lm.Batch):
    """``(loss, grads)`` of ``model.loss`` with respect to ``params`` as
    they are (the float32 masters: each product casts its weight to the
    compute dtype, and the gradients come back in float32); the loss and
    the backward pass in one :func:`~repro_torch.pin_detector_matmul`
    scope, where every remat recompute runs too."""
    with torch.enable_grad():
        ps = common.tree_map(lambda p: p.detach().requires_grad_(), params)
        with pin_detector_matmul():
            loss = model.loss(ps, batch)
            flat = iter(torch.autograd.grad(loss, common.leaves(ps)))
    return loss.detach(), common.tree_map(lambda _: next(flat), params)


def make_train_step(model: lm.Model, opt: optim.AdamW,
                    microbatches: int = 1) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    ``metrics`` ``{"loss", "grad_norm"}`` as 0-d float32 tensors on the
    device.

    With ``microbatches > 1`` the leading dim of every field of the batch
    is cut into ``microbatches`` equal parts, and their gradients are
    added into float32 zeros in order; the loss is the mean of the parts'
    losses and each gradient their sum over ``microbatches``, as the
    reference's ``lax.scan``. ``grad_norm`` is the norm of the averaged
    gradients, before AdamW clips them."""

    def step(params, opt_state, batch: lm.Batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            def part(x, i):
                if x is None:
                    return None
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])[i]

            loss = torch.zeros((), dtype=torch.float32,
                               device=common.leaves(params)[0].device)
            grads = common.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for i in range(microbatches):
                li, gi = loss_and_grads(
                    model, params, lm.Batch(*(part(x, i) for x in batch)))
                loss = loss + li
                gs = iter(common.leaves(gi))
                grads = common.tree_map(lambda g: g + next(gs), grads)
            loss = common.true_divide(loss, microbatches)
            grads = common.tree_map(
                lambda g: common.true_divide(g, microbatches), grads)
        with torch.no_grad():
            gnorm = optim.global_norm(grads)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def train(model: lm.Model, data: Iterator[lm.Batch], tc: TrainConfig, *,
          params=None, on_metrics: Callable[[int, dict], None] | None = None,
          device: str | torch.device | None = None) -> dict:
    """Run (or resume) training: ``{params, opt_state, step, history}``.

    AdamW on ``warmup_cosine(tc.lr, tc.warmup, tc.steps)``; ``params=None``
    draws ``model.init`` from a generator seeded 0 on ``device`` (``None``
    -> CUDA, raising without it). With a checkpoint in ``tc.ckpt_dir``
    the parameters and AdamW state are restored onto ``device`` and the
    loop goes on from its step; ``data`` must then start at that step
    (``synthetic_lm_data(..., start_step=)``). A checkpoint every
    ``tc.ckpt_every`` steps (written in the background), one on SIGTERM
    (the handler installed for the loop's run and the caller's put back
    after it), and a last one, written before returning. The loss is read
    back to the host on a log step alone (every ``tc.log_every`` steps
    and the first), where it is printed and handed to ``on_metrics``."""
    dev = resolve_device(device)
    opt = optim.AdamW(lr=optim.warmup_cosine(tc.lr, tc.warmup, tc.steps),
                      weight_decay=tc.weight_decay)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)

    start_step = 0
    latest = ckpt.latest_step(tc.ckpt_dir)
    if latest is not None:
        (params, opt_state), extra = ckpt.restore(
            tc.ckpt_dir, (params, opt_state), device=dev)
        start_step = extra.get("step", latest)
        print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = make_train_step(model, opt, tc.microbatches)
    saver = ckpt.AsyncCheckpointer(tc.ckpt_dir, keep=tc.keep)
    state = {"params": params, "opt_state": opt_state, "step": start_step}

    def emergency_save():
        saver.wait()
        ckpt.save(tc.ckpt_dir, state["step"],
                  (state["params"], state["opt_state"]),
                  keep=tc.keep, extra={"step": state["step"]})
        print(f"[train] preemption checkpoint at step {state['step']}",
              flush=True)

    before = signal.getsignal(signal.SIGTERM)
    ckpt.install_preemption_handler(emergency_save)
    try:
        t0 = time.time()
        history = []
        for step_i in range(start_step, tc.steps):
            batch = next(data)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            state.update(params=params, opt_state=opt_state, step=step_i + 1)
            if (step_i + 1) % tc.log_every == 0 or step_i == start_step:
                loss = float(metrics["loss"])
                history.append(loss)
                dt = time.time() - t0
                print(f"[train] step {step_i + 1}/{tc.steps} "
                      f"loss {loss:.4f} gnorm "
                      f"{float(metrics['grad_norm']):.3f} ({dt:.1f}s)",
                      flush=True)
                if on_metrics:
                    on_metrics(step_i + 1, {k: float(v)
                                            for k, v in metrics.items()})
            if (step_i + 1) % tc.ckpt_every == 0:
                saver.save(step_i + 1, (params, opt_state),
                           extra={"step": step_i + 1})
        saver.wait()
        ckpt.save(tc.ckpt_dir, tc.steps, (params, opt_state), keep=tc.keep,
                  extra={"step": tc.steps})
    finally:
        signal.signal(signal.SIGTERM, before)
    return {"params": params, "opt_state": opt_state,
            "step": tc.steps, "history": history}


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
