"""Analytic per-device memory model of a cell, on the H100's figures.

The twin of ``repro.distributed.memory_model``: the same terms, computed
from the same shardings (:func:`~repro_torch.distributed.sharding.spec_for`
of every parameter's logical axes on the mesh), term by term:

train:   params(fp32) + adam(mu,nu fp32) + grads(fp32, transient)
         + saved residuals (L x b_loc x s_shard x d, bf16, seq-parallel)
         + max transient (attention block scores / MoE buffers / loss chunk)
decode:  params(bf16-equivalent) + decode state (each leaf's block, the
         KV caches', the hybrid's SSM states' and the xLSTM's per-block
         states', under ``spec_for`` of its logical axes) + small
         transients
prefill: params + live activations (one layer) + logits

A mesh is a ``DeviceMesh`` with named dimensions or a ``{name: size}``
mapping (an abstract mesh: ``{"data": 16, "model": 16}``). The model
counts what the reference's compiled step keeps; the port's eager
autograd keeps more (the recomputed layer's float32 score and softmax
blocks, the float32 copies of q, k and v), so the allocator's peak on
the card sits above it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.models import common, lm

#: one H100's device memory, GB
H100_GB = 80.0


def _shards(mshape: dict, spec) -> int:
    n = 1
    flat = []
    for p in spec:
        if p is None:
            continue
        if isinstance(p, (tuple, list)):
            flat.extend(p)
        else:
            flat.append(p)
    for ax in flat:
        n *= mshape[ax]
    return n


def _is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and Nones."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _tree_bytes_per_device(spec_tree, mesh, rules, bytes_per_el: int) -> int:
    mshape = sharding.mesh_shape(mesh)
    total = 0
    for p in common.leaves(spec_tree):
        sh = sharding.spec_for(p.shape, p.axes, mesh, rules)
        total += math.prod(p.shape) * bytes_per_el // _shards(mshape, sh)
    return total


@dataclass
class MemoryBreakdown:
    params_gb: float
    opt_state_gb: float
    grads_gb: float
    residuals_gb: float
    transient_gb: float
    state_gb: float = 0.0
    detail: dict = field(default_factory=dict)

    @property
    def total_gb(self) -> float:
        return (self.params_gb + self.opt_state_gb + self.grads_gb
                + self.residuals_gb + self.transient_gb + self.state_gb)

    @property
    def fits_h100(self) -> bool:
        """The total within one H100's 80 GB (the reference's
        ``fits_v5e`` held it to a v5e's 16 GB)."""
        return self.total_gb <= H100_GB


def analyze(cfg, shape, mesh, rules=None) -> MemoryBreakdown:
    """The breakdown of ``cfg``'s ``shape`` cell a device of ``mesh``
    holds, under ``rules`` over the default rules."""
    model = lm.Model(cfg)
    spec = model.spec()
    rules = dict(sharding.DEFAULT_RULES, **(rules or {}))

    mesh_axes = sharding.mesh_shape(mesh)
    model_deg = mesh_axes.get("model", 1)
    data_deg = mesh_axes.get("data", 1) * mesh_axes.get("pod", 1)

    p32 = _tree_bytes_per_device(spec, mesh, rules, 4)
    b = shape.global_batch
    s = shape.seq_len
    d = cfg.d_model
    b_loc = max(b // data_deg, 1)

    if shape.kind == "train":
        params = p32
        opt = 2 * p32
        grads = p32
        s_shard = max(s // model_deg, 1) if s % model_deg == 0 else s
        resid = cfg.n_layers * b_loc * s_shard * d * 2
        h_loc = max(cfg.n_heads // model_deg, 1)
        qc = min(1024, s)
        attn_t = 2 * b_loc * h_loc * qc * s * 4          # scores + attn
        v_loc = max(cfg.vocab // model_deg, 1) if cfg.vocab % model_deg == 0 \
            else cfg.vocab
        loss_t = 3 * b_loc * min(1024, s) * v_loc * 4
        moe_t = 0
        if cfg.n_experts:
            n_tok = b_loc * s
            cap = int(n_tok * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts)
            e_loc = max(cfg.n_experts // model_deg, 1) \
                if cfg.n_experts % model_deg == 0 else cfg.n_experts
            cap_loc = cap if cfg.n_experts % model_deg == 0 \
                else max(cap // model_deg, 1)
            moe_t = 3 * e_loc * cap_loc * max(cfg.d_ff, d) * 2
        transient = max(attn_t, loss_t, moe_t) + 2 * b_loc * s * d * 2
        return MemoryBreakdown(
            params_gb=params / 1e9, opt_state_gb=opt / 1e9,
            grads_gb=grads / 1e9, residuals_gb=resid / 1e9,
            transient_gb=transient / 1e9,
            detail={"attn_t_gb": attn_t / 1e9, "loss_t_gb": loss_t / 1e9,
                    "moe_t_gb": moe_t / 1e9})

    # inference: bf16-weights footprint
    params = p32 // 2
    state_bytes = 0
    if shape.kind == "decode":
        st_spec = model.decode_state_spec(batch=b, max_seq=s)
        axes: list = []
        common.tree_map(axes.append, steps._decode_state_axes(model),
                        _is_axes)
        for t, ax in zip(common.leaves(st_spec), axes, strict=True):
            sh = sharding.spec_for(t.shape, ax, mesh, rules)
            state_bytes += (math.prod(t.shape) * t.element_size()
                            // _shards(mesh_axes, sh))
        transient = b_loc * d * 4 * 8
    else:  # prefill
        transient = (2 * b_loc * s * d * 2
                     + b_loc * max(cfg.n_heads // model_deg, 1)
                     * min(1024, s) * s * 4)
        v_loc = max(cfg.vocab // model_deg, 1) \
            if cfg.vocab % model_deg == 0 else cfg.vocab
        transient += b_loc * s * v_loc * 2     # output logits
    return MemoryBreakdown(
        params_gb=params / 1e9, opt_state_gb=0.0, grads_gb=0.0,
        residuals_gb=0.0, transient_gb=transient / 1e9,
        state_gb=state_bytes / 1e9)
