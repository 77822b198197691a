"""Carry a HyperSense model's, a Fragment model's, a detector's, an LM's
or a baseline's weights, an AdamW state, a training state (an LM's
parameters and its AdamW state), compressed gradients or an LM's decode
state (its KV cache, the hybrid's SSM states and KV caches, or the
xLSTM's per-block states) across into the port.

The tests build a model in the JAX package and hand its arrays over as
numpy (``np.asarray(jax_model.class_hvs)`` etc.), so that both packages
compute with identical parameters, take a step from the same mid-run
state, or decode from the same half-filled cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.encoding import NonLin
from repro_torch.core.fragment_model import FragmentModel
from repro_torch.core.hypersense import HyperSenseModel
from repro_torch.models import common
from repro_torch.models.attention import KVCache
from repro_torch.models.lm import dtype_of
from repro_torch.models.ssm import SSMState
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.sensing.baselines import MLP, TinyConv
from repro_torch.train.compress import QGrad
from repro_torch.train.optim import AdamWState


def _float32_on(device):
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)
    return t


def model_from_arrays(class_hvs, B0, b, *, h: int, w: int, stride: int,
                      t_score: float, t_detection: int,
                      nonlinearity: NonLin = "rff",
                      device: str | torch.device | None = None
                      ) -> HyperSenseModel:
    """A :class:`HyperSenseModel` from ``(2, D)`` class hypervectors, the
    ``(h, D)`` generators and the ``(D,)`` phase, as float32 on ``device``
    (``None`` -> CUDA, raising without it)."""
    t = _float32_on(device)
    B0 = t(B0)
    if B0.shape[0] != h:
        raise ValueError(f"B0 has {B0.shape[0]} generator rows, h={h}")
    return HyperSenseModel(class_hvs=t(class_hvs), B0=B0, b=t(b), h=h, w=w,
                           stride=stride, t_score=float(t_score),
                           t_detection=int(t_detection),
                           nonlinearity=nonlinearity)


def fragment_model_from_arrays(class_hvs, B, b, *,
                               device: str | torch.device | None = None
                               ) -> FragmentModel:
    """A :class:`FragmentModel` from ``(C, D)`` class hypervectors, the
    ``(n, D)`` base and the ``(D,)`` phase, as float32 on ``device``
    (``None`` -> CUDA, raising without it)."""
    t = _float32_on(device)
    class_hvs, B, b = t(class_hvs), t(B), t(b)
    if B.shape[1] != class_hvs.shape[1] or b.shape != (B.shape[1],):
        raise ValueError(f"class_hvs {tuple(class_hvs.shape)}, B "
                         f"{tuple(B.shape)} and b {tuple(b.shape)} do not "
                         f"share one D")
    return FragmentModel(class_hvs=class_hvs, B=B, b=b)


def detector_params_from_arrays(tree, *,
                                device: str | torch.device | None = None
                                ) -> dict:
    """The port's detector parameters from the reference's
    ``init_detector_params`` tree as numpy arrays: the same nested dicts and
    leaf names (``{"backbone": {..., "layers": {"attn": {"wq": (L, d, h,
    hd), ...}}}, "embedder": {"proj", "pos"}}``, layers stacked on a leading
    axis), each leaf float32 on ``device`` (``None`` -> CUDA, raising
    without it)."""
    if set(tree) != {"backbone", "embedder"}:
        raise ValueError(f"a detector tree has 'backbone' and 'embedder', "
                         f"got {sorted(tree)}")
    return common.tree_map(_float32_on(device), tree)


def lm_params_from_arrays(tree, *, cfg,
                          device: str | torch.device | None = None) -> dict:
    """The port's :class:`~repro_torch.models.lm.Model` parameters from the
    reference's ``Model.init`` tree as numpy arrays (the same nesting and
    leaf names, layers stacked on a leading axis or listed; the token
    embedding's ``embed`` subtree; a parameter-free norm's empty
    subtree, kept empty; the xLSTM's ``{"mlstm", "slstm"}`` stacks), each
    leaf in ``cfg.param_dtype`` on ``device``
    (``None`` -> CUDA, raising without it)."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)
    return common.tree_map(
        lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev
                                  ).to(dt), tree)


def adamw_state_from_arrays(state, *,
                            device: str | torch.device | None = None
                            ) -> AdamWState:
    """An :class:`~repro_torch.train.optim.AdamWState` from the reference's
    ``optim.AdamWState`` as numpy arrays: the int32 step and the ``mu`` and
    ``nu`` trees, each leaf in its own dtype, on ``device`` (``None`` ->
    CUDA, raising without it)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)
    return AdamWState(step=t(np.asarray(state.step, np.int32)),
                      mu=common.tree_map(t, state.mu),
                      nu=common.tree_map(t, state.nu))


def train_state_from_arrays(params, state, *, cfg,
                            device: str | torch.device | None = None
                            ) -> tuple[dict, AdamWState]:
    """The ``(params, opt_state)`` pair the train loop checkpoints, from the
    reference's (its ``Model.init`` tree and ``optim.AdamWState``, as numpy
    arrays): :func:`lm_params_from_arrays` and
    :func:`adamw_state_from_arrays`, on ``device`` (``None`` -> CUDA,
    raising without it)."""
    return (lm_params_from_arrays(params, cfg=cfg, device=device),
            adamw_state_from_arrays(state, device=device))


def _is_qgrad(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == (
        "q", "scale")


def qgrads_from_arrays(tree, *, device: str | torch.device | None = None):
    """The port's compressed gradients from the reference's
    ``compress_grads`` tree as numpy arrays: each ``QGrad``'s int8 codes
    and float32 scales, the nesting kept, on ``device`` (``None`` -> CUDA,
    raising without it)."""
    dev = resolve_device(device)
    return common.tree_map(
        lambda x: QGrad(q=torch.as_tensor(np.asarray(x.q, np.int8),
                                          device=dev),
                        scale=torch.as_tensor(np.asarray(x.scale,
                                                         np.float32),
                                              device=dev)),
        tree, _is_qgrad)


def kv_cache_from_arrays(state, *,
                         device: str | torch.device | None = None
                         ) -> KVCache:
    """The port's decode state from the reference's (``Model.
    init_decode_state``'s stacked ``KVCache``, or one layer's) as numpy
    arrays: its ``k`` and ``v`` leaves in bf16, the cache's dtype in both
    packages, on ``device`` (``None`` -> CUDA, raising without it). A
    bf16 leaf passes through float32 exactly; a float32 one is rounded
    to bf16."""
    dev = resolve_device(device)
    return KVCache(*(torch.as_tensor(np.asarray(a, np.float32), device=dev
                                     ).to(torch.bfloat16)
                     for a in (state.k, state.v)))


def hybrid_state_from_arrays(state, *,
                             device: str | torch.device | None = None
                             ) -> dict:
    """The hybrid's decode state from the reference's (``Model.
    init_decode_state``'s ``{"mamba": SSMState, "attn": KVCache}``) as
    numpy arrays, on ``device`` (``None`` -> CUDA, raising without it):
    the recurrent ``ssm`` leaf in float32, as in both packages; the
    ``conv`` buffer and the ``k`` and ``v`` leaves in bf16
    (:func:`kv_cache_from_arrays`: a bf16 leaf passes through float32
    exactly, a float32 one is rounded)."""
    dev = resolve_device(device)
    mamba = state["mamba"]

    def bf16(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev
                               ).to(torch.bfloat16)
    # a copy: the decode step writes the state in place
    return {"mamba": SSMState(
                torch.tensor(np.asarray(mamba.ssm, np.float32), device=dev),
                bf16(mamba.conv)),
            "attn": kv_cache_from_arrays(state["attn"], device=dev)}


def xlstm_state_from_arrays(state, *,
                            conv_dtype: torch.dtype = torch.bfloat16,
                            device: str | torch.device | None = None
                            ) -> list:
    """The xLSTM's decode state from the reference's (``Model.
    init_decode_state``'s list of one ``MLSTMState`` or ``SLSTMState`` a
    block) as numpy arrays, on ``device`` (``None`` -> CUDA, raising
    without it): the mLSTM's C, n and m and the sLSTM's four leaves in
    float32, copies (the decode step writes the state in place); the
    mLSTM's convolution buffer in ``conv_dtype`` (bf16, the reference's
    default: a bf16 leaf passes through float32 exactly, a float32 one
    is rounded)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    out: list = []
    for st in state:
        if hasattr(st, "C"):
            out.append(MLSTMState(f32(st.C), f32(st.n), f32(st.m),
                                  f32(st.conv).to(conv_dtype)))
        else:
            out.append(SLSTMState(*map(f32, st)))
    return out


def baseline_from_arrays(tree, *, kind: str,
                         device: str | torch.device | None = None
                         ) -> MLP | TinyConv:
    """A Table I baseline from the reference's parameter tree as numpy
    arrays, float32 on ``device`` (``None`` -> CUDA, raising without it).

    ``kind="mlp"``: ``init_mlp``'s list of ``{"w": (n_in, n_out), "b"}``;
    ``kind="tiny_conv"``: ``init_tiny_conv``'s ``{"convs": [{"w": (kh, kw,
    cin, cout), "b"}, ...], "head": {"w", "b"}}``. Dense weights become
    ``(n_out, n_in)`` and convolution kernels ``(cout, cin, kh, kw)``.
    """
    def dense(layer):
        return {"w": np.asarray(layer["w"]).T, "b": np.asarray(layer["b"])}

    if kind == "mlp":
        arrays = [dense(layer) for layer in tree]
        module = MLP([arrays[0]["w"].shape[1]]
                     + [a["w"].shape[0] for a in arrays], device=device)
    elif kind == "tiny_conv":
        arrays = {"convs": [{"w": np.transpose(np.asarray(c["w"]),
                                               (3, 2, 0, 1)),
                             "b": np.asarray(c["b"])}
                            for c in tree["convs"]],
                  "head": dense(tree["head"])}
        module = TinyConv([c["w"].shape[0] for c in arrays["convs"]],
                          device=device)
    else:
        raise ValueError(f"unknown baseline kind {kind!r}")
    t = _float32_on(device)
    with torch.no_grad():
        for p, a in zip(common.leaves(module.tree()), common.leaves(arrays)):
            if tuple(p.shape) != a.shape:
                raise ValueError(f"a {kind} leaf of shape {a.shape} does not "
                                 f"fit {tuple(p.shape)}")
            p.copy_(t(a))
    return module
