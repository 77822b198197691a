"""Baseline detectors the paper compares against (Table I, Figs. 11, 16),
on PyTorch.

Twin of ``repro.sensing.baselines``:

* :class:`MLP` — the "small multi-layer perceptron" baselines (2 and 4
  layers);
* :class:`TinyConv` — the YOLOv4-tiny stand-in: a small conv tower and a
  dense head on a global average pool.

Both are ``nn.Module``s whose parameters form the reference's tree
(:meth:`MLP.tree`, :meth:`TinyConv.tree`: a list of ``{"w", "b"}``, and
``{"convs": [...], "head": {...}}``), trained by :func:`train_classifier`
with the port's :class:`repro_torch.train.optim.AdamW`. The reference is
NHWC with HWIO kernels and ``(n_in, n_out)`` dense weights; the port is
NCHW with OIHW kernels and ``(n_out, n_in)`` weights
(:func:`repro_torch.convert.baseline_from_arrays` carries weights across).

The products are library calls (``F.linear``, cuDNN's ``F.conv2d``), as
the reference's are outside any kernel. They run in :func:`pin_conv`'s
scope: full float32 (no TF32) and deterministic cuDNN algorithms, the
caller's flags restored on exit. A module lives on the device its
generator (or ``device``) names.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import pin_conv, resolve_device
from repro_torch.models.common import leaves, tree_map
from repro_torch.train import optim


class Dense(nn.Module):
    """``x @ w.T + b`` with a ``(n_out, n_in)`` weight and zero bias."""

    def __init__(self, n_in: int, n_out: int, *, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((n_out, n_in), device=device))
        self.bias = nn.Parameter(torch.zeros((n_out,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def tree(self) -> dict:
        return {"w": self.weight, "b": self.bias}


class Conv(nn.Module):
    """3x3 ``SAME`` convolution (stride 1, padding 1), OIHW weight."""

    def __init__(self, cin: int, cout: int, *, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin, 3, 3),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros((cout,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, padding=1)

    def tree(self) -> dict:
        return {"w": self.weight, "b": self.bias}


class MLP(nn.Module):
    """``(N, ...)`` -> ``(N, 2)`` logits: flatten, L2-normalize
    (``max(norm, 1e-8)``), dense layers of ``sizes`` with a ReLU between."""

    def __init__(self, sizes: Sequence[int], *,
                 device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.layers = nn.ModuleList(Dense(a, b, device=dev)
                                    for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                            min=1e-8)
        with pin_conv():
            for i, layer in enumerate(self.layers):
                h = layer(h)
                if i < len(self.layers) - 1:
                    h = torch.relu(h)
        return h

    def tree(self) -> list[dict]:
        return [layer.tree() for layer in self.layers]


class TinyConv(nn.Module):
    """``(N, h, w)`` -> ``(N, 2)`` logits: per channel count a 3x3 ``SAME``
    convolution, ReLU and a 2x2 max pool of stride 2 (flooring, as
    ``VALID``); a global average pool; a dense head."""

    def __init__(self, channels: Sequence[int], *,
                 device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        cins = (1, *channels[:-1])
        self.convs = nn.ModuleList(Conv(a, b, device=dev)
                                   for a, b in zip(cins, channels))
        self.head = Dense(channels[-1], 2, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]
        with pin_conv():
            for conv in self.convs:
                h = F.max_pool2d(torch.relu(conv(h)), 2)
            return self.head(h.mean(dim=(2, 3)))

    def tree(self) -> dict:
        return {"convs": [conv.tree() for conv in self.convs],
                "head": self.head.tree()}


def _fill(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Each weight ``sqrt(2 / fan_in) * N(0, 1)`` from ``generator``, in
    the order the reference draws them (layer by layer); biases stay 0."""
    with torch.no_grad():
        for layer in module.modules():
            if isinstance(layer, (Dense, Conv)):
                w = layer.weight
                fan_in = math.prod(w.shape[1:])
                w.copy_(math.sqrt(2.0 / fan_in) * torch.randn(
                    w.shape, generator=generator, device=w.device))
    return module


def init_mlp(generator: torch.Generator, n_in: int, hidden: int = 256,
             n_layers: int = 2) -> MLP:
    """``n_layers`` counts hidden layers + output layer (paper: 2 and 4).
    On the generator's device."""
    sizes = [n_in] + [hidden] * (n_layers - 1) + [2]
    return _fill(MLP(sizes, device=generator.device), generator)


def init_tiny_conv(generator: torch.Generator,
                   channels: tuple[int, ...] = (16, 32, 64)) -> TinyConv:
    """On the generator's device."""
    return _fill(TinyConv(channels, device=generator.device), generator)


def mlp_apply(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """(N, n_in) -> (N, 2) logits."""
    return params(x)


def tiny_conv_apply(params: TinyConv, x: torch.Tensor) -> torch.Tensor:
    """(N, h, w) -> (N, 2) logits: conv/pool tower + GAP head."""
    return params(x)


# ---------------------------------------------------------------------------
# Shared trainer
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


def loss_and_grads(params: nn.Module, apply_fn: Callable,
                   xb: torch.Tensor, yb: torch.Tensor
                   ) -> tuple[torch.Tensor, list | dict]:
    """The batch cross-entropy and its autograd gradients as a tree of the
    parameters' structure (the reference's ``jax.value_and_grad`` of
    ``_xent(apply_fn(p, xb), yb)``), forward and backward in
    :func:`pin_conv`'s scope."""
    tree = params.tree()
    with pin_conv():
        loss = _xent(apply_fn(params, xb), yb)
        grads = iter(torch.autograd.grad(loss, leaves(tree)))
    return loss.detach(), tree_map(lambda _: next(grads), tree)


def train_step(params: nn.Module, apply_fn: Callable, opt: optim.AdamW,
               opt_state: optim.AdamWState, xb: torch.Tensor,
               yb: torch.Tensor) -> tuple[optim.AdamWState, torch.Tensor]:
    """One minibatch step of :func:`train_classifier`, in place on
    ``params``: :func:`loss_and_grads`, ``opt.update`` and
    :func:`repro_torch.train.optim.apply_updates`. Returns the new
    optimizer state and the batch loss."""
    loss, grads = loss_and_grads(params, apply_fn, xb, yb)
    tree = params.tree()
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, tree)
        for p, q in zip(leaves(tree),
                        leaves(optim.apply_updates(tree, updates))):
            p.copy_(q)
    return opt_state, loss


def train_classifier(generator: torch.Generator, params: nn.Module,
                     apply_fn: Callable, frags, labels, *, epochs: int = 30,
                     batch_size: int = 64, lr: float = 1e-3) -> nn.Module:
    """Minibatch AdamW training; returns the trained module (``params``
    itself is left as it was). Each epoch draws one permutation from
    ``generator`` (on its own device) and takes ``max(n // batch_size, 1)``
    batches of it; the training runs on the module's device."""
    params = copy.deepcopy(params)
    dev = next(params.parameters()).device
    frags = torch.as_tensor(frags, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev).long()
    opt = optim.AdamW(lr=lr, weight_decay=1e-4)
    opt_state = opt.init(params.tree())
    n = frags.shape[0]
    steps = max(n // batch_size, 1)
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator,
                              device=generator.device).to(dev)
        for i in range(steps):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            opt_state, _ = train_step(params, apply_fn, opt, opt_state,
                                      frags[idx], labels[idx])
    return params


def positive_score(apply_fn: Callable, params: nn.Module,
                   frags: torch.Tensor) -> torch.Tensor:
    """Detection score: logit margin (same convention as the HDC model)."""
    with torch.no_grad():
        logits = apply_fn(params, frags)
    return logits[:, 1] - logits[:, 0]
