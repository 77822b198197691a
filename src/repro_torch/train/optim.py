"""Optimizers and learning-rate schedules on PyTorch.

Twin of ``repro.train.optim``, whole:

* AdamW with decoupled weight decay and bias-corrected moments;
* global-norm gradient clipping;
* warmup + cosine / linear / constant schedules;
* SGD with momentum.

Parameters, gradients, moments and updates are trees of tensors (nested
dicts and lists), walked with :func:`repro_torch.models.common.tree_map`,
which visits dict keys in the reference's sorted order, so
:func:`global_norm` sums its leaves in the reference's order. ``update``
returns the updates; :func:`apply_updates` adds them. No
``torch.optim`` class stands in: the reference's AdamW clips before the
moments, uses ``b2 = 0.95`` and puts the decay inside the ``lr``
product, ``-lr * (mhat / (sqrt(vhat) + eps) + wd * p)``.

Every function runs on the device of the tensors it is given. A Python
scalar that divides a tensor is made a 0-d tensor first, so the card
divides as the CPU does (it would multiply by the reciprocal).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.distributed.sharding import fold_partials
from repro_torch.models.common import leaves, tree_map

PyTree = object
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, zipped in the reference's leaf order; the
    structure of ``tree`` kept."""
    out = iter([fn(*xs) for xs in zip(leaves(tree),
                                      *(leaves(r) for r in rest))])
    return tree_map(lambda _: next(out), tree)


def _scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _lr(lr: Schedule | float, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _step0(params: PyTree) -> torch.Tensor:
    """The int32 step counter at 0, on the device of the first leaf."""
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: PyTree           # first moment
    nu: PyTree           # second moment


class AdamW(NamedTuple):
    """AdamW config, with ``init`` and ``update`` as the reference's."""
    lr: Schedule | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0

    def init(self, params: PyTree) -> AdamWState:
        return AdamWState(step=_step0(params),
                          mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params))

    def update(self, grads: PyTree, state: AdamWState, params: PyTree,
               norm_groups: PyTree | None = None
               ) -> tuple[PyTree, AdamWState]:
        """``(updates, state)``; on a mesh, ``grads``, ``state`` and
        ``params`` are this rank's blocks and ``norm_groups`` the clip's
        groups (:func:`global_norm`): the update itself is elementwise."""
        step = state.step + 1
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm, norm_groups)
        b1, b2 = self.b1, self.b2
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        s = step.to(torch.float32)
        bc1 = 1 - torch.pow(_scalar(s, b1), s)
        bc2 = 1 - torch.pow(_scalar(s, b2), s)
        lr = _lr(self.lr, step)

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            u = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return (-lr * u).to(p.dtype)

        updates = _map(upd, params, mu, nu)
        return updates, AdamWState(step=step, mu=mu, nu=nu)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: PyTree


class SGD(NamedTuple):
    lr: Schedule | float = 1e-2
    momentum: float = 0.9
    clip_norm: float | None = None

    def init(self, params: PyTree) -> SGDState:
        return SGDState(step=_step0(params),
                        momentum=tree_map(torch.zeros_like, params))

    def update(self, grads: PyTree, state: SGDState, params: PyTree
               ) -> tuple[PyTree, SGDState]:
        step = state.step + 1
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        mom = _map(lambda m, g: self.momentum * m + g, state.momentum, grads)
        lr = _lr(self.lr, step)
        updates = _map(lambda p, m: (-lr * m).to(p.dtype), params, mom)
        return updates, SGDState(step=step, momentum=mom)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return _map(lambda p, u: p + u, params, updates)


def global_norm(tree: PyTree, groups: PyTree | None = None
                ) -> torch.Tensor:
    """The float32 norm of every leaf together, the leaves' sums of squares
    added in the reference's order. On a mesh, ``tree`` holds this rank's
    blocks and ``groups`` (a tree of the same structure) each leaf's
    process group over the mesh dims its spec splits it over, or None:
    each block's sum of squares is folded over its group first
    (:func:`~repro_torch.distributed.sharding.fold_partials`), so a leaf
    replicated over a dim is counted once, and every rank gets the same
    norm."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    if groups is not None:
        sq = [s if g is None else fold_partials(s, g)
              for s, g in zip(sq, leaves(groups))]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads: PyTree, max_norm: float,
                        groups: PyTree | None = None) -> PyTree:
    norm = global_norm(grads, groups)
    scale = torch.clamp(_scalar(norm, max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    # JAX's promotion: a bf16 gradient times the float32 scale is float32
    # (torch would keep a 0-d tensor's product in bf16)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                    * scale, grads)


# ---------------------------------------------------------------------------
# Schedules: step (int32 tensor) -> lr (float32 tensor)
# ---------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / _scalar(s, max(warmup_steps, 1))
        prog = torch.clamp((s - warmup_steps) / _scalar(
            s, max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)
    return sched


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int
                  ) -> Schedule:
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / _scalar(s, max(warmup_steps, 1))
        prog = torch.clamp((s - warmup_steps) / _scalar(
            s, max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        return torch.where(s < warmup_steps, warm, peak_lr * (1 - prog))
    return sched


def constant(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)
