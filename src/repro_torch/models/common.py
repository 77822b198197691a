"""Shared model substrate on PyTorch: parameter specs and their
sharding, norms, RoPE, the token embedding and the unembedding. The
twin of ``repro.models.common``.

Every parameter is declared once as :class:`P` (shape, logical axes,
init); :func:`init_params` materialises a spec tree (nested dicts and
lists) in the reference's leaf order. The logical axes place it on a
mesh: :func:`param_specs` (the twin of ``param_shardings``) gives each
leaf's :func:`~repro_torch.distributed.sharding.spec_for` entry,
:func:`local_params` cuts this rank's blocks, and :class:`Parallel` is
what a sharded forward asks of the mesh. :func:`abstract_params` is the
same tree on ``device="meta"`` (shapes and dtypes, no storage), what a
cell is counted on, and :func:`abstract_local_params` this rank's blocks
of it. :func:`embed` is vocab-parallel under a :class:`Parallel`: each
rank looks up the tokens of its vocab block, and the blocks' rows are
folded, one nonzero row a token, so the sum is exact.

The norms keep the reference's dtype discipline: float32 statistics, the
normalisation applied in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed import sharding


class P(NamedTuple):
    """Declaration of one parameter tensor."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"            # normal | zeros | ones
    scale: float | None = None      # stddev; default fan-in

    def with_layers(self, n_layers: int) -> "P":
        """Prefix a stacked ``layers`` dim."""
        return P((n_layers, *self.shape), ("layers", *self.axes),
                 self.init, self.scale)


SpecTree = Any  # nested dict[str, P]


def tree_map(fn: Callable, tree, is_leaf: Callable = None):
    """``fn`` over the leaves of nested dicts and lists, keys visited in
    sorted order (the reference's ``jax.tree`` order); the structure kept.
    """
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [tree_map(fn, v, is_leaf) for v in tree]
    return fn(tree)


def _is_p(x) -> bool:
    return isinstance(x, P)


def map_layers(spec: SpecTree, n_layers: int) -> SpecTree:
    return tree_map(lambda p: p.with_layers(n_layers), spec, _is_p)


def init_params(generator: torch.Generator, spec: SpecTree,
                dtype: torch.dtype = torch.float32) -> dict:
    """Draw a spec tree on the generator's device, leaf by leaf in the
    reference's order. ``normal`` leaves are ``scale * N(0, 1)`` with the
    reference's default scale ``fan_in ** -0.5``, where ``fan_in`` is
    ``shape[-2]`` (for the 3-D attention weights ``(d, heads, head_dim)``
    that is the head count, as in the reference)."""
    dev = generator.device

    def one(p: P) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else fan_in ** -0.5
        return (scale * torch.randn(p.shape, generator=generator, device=dev,
                                    dtype=torch.float32)).to(dtype)

    return tree_map(one, spec, _is_p)


def abstract_params(spec: SpecTree,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The spec tree as meta tensors of ``dtype``: the twin of the
    reference's ``ShapeDtypeStruct`` tree, for counting a step without
    allocating it."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                          device="meta"), spec, _is_p)


def spec_param_count(spec: SpecTree) -> int:
    """Elements declared by a spec tree (:func:`count_params` of it)."""
    return count_params(spec)


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------

def param_specs(spec: SpecTree, mesh, rules: dict | None = None) -> dict:
    """Each declared parameter's spec on ``mesh`` (one entry per dim: a
    mesh dim's name, a tuple of names, or None), from its logical axes:
    the twin of the reference's ``param_shardings``. The tree of ``spec``
    with a tuple at every leaf."""
    return tree_map(lambda p: sharding.spec_for(p.shape, p.axes, mesh,
                                                rules), spec, _is_p)


def local_params(params, specs, mesh):
    """This rank's block of every tensor of ``params`` (the whole tree,
    the same on every rank) under ``specs`` (:func:`param_specs`)."""
    if isinstance(params, dict):
        return {k: local_params(params[k], specs[k], mesh)
                for k in sorted(params)}
    if isinstance(params, list):
        return [local_params(p, s, mesh) for p, s in zip(params, specs)]
    return sharding.local_block(params, specs, mesh)


def abstract_local_params(spec: SpecTree, mesh, rules: dict | None = None,
                          dtype: torch.dtype = torch.float32) -> dict:
    """The meta-tensor twin of :func:`local_params`: each leaf at the shape
    of this rank's block under :func:`param_specs` on ``mesh``, allocating
    nothing (what the dry run counts a rank's step on)."""
    return local_params(abstract_params(spec, dtype),
                        param_specs(spec, mesh, rules), mesh)


class Parallel(NamedTuple):
    """A mesh as the sharded forward sees it. Weights are this rank's
    blocks (:func:`local_params`); each is declared by a :class:`P` whose
    logical axes say how it was cut, by ``rules`` (None: the current
    rules, :data:`~repro_torch.distributed.sharding.DEFAULT_RULES`
    outside a ``use_mesh`` scope). ``batch``: the whole batch's sequences,
    of which the inputs are this rank's block (what the mixture of
    experts routes together needs it; None elsewhere will do)."""
    mesh: Any
    rules: dict | None = None
    batch: int | None = None

    def spec(self, p: P) -> tuple:
        return sharding.spec_for(p.shape, p.axes, self.mesh, self.rules)

    def group(self, p: P, logical: str):
        """The process group ``p``'s ``logical`` dim is split over, or None
        when :func:`~repro_torch.distributed.sharding.spec_for` leaves it
        whole."""
        axes = self.spec(p)[p.axes.index(logical)]
        return None if axes is None else sharding.axis_group(self.mesh,
                                                             axes)

    def enter(self, x: torch.Tensor, p: P, logical: str) -> torch.Tensor:
        """``x``, replicated over the group ``p``'s ``logical`` dim is split
        over, entering the column-parallel product with ``p``
        (:func:`~repro_torch.distributed.sharding.enter_group`: its
        gradient folded over that group); ``x`` itself where the dim is
        whole."""
        g = self.group(p, logical)
        return x if g is None else sharding.enter_group(x, g)

    def batch_group(self):
        """The group of the mesh dims the rules map ``"act_batch"`` to,
        whether or not they split a given batch (a batch they do not
        split runs whole on each of their ranks), or None."""
        axes, _ = sharding.mesh_extent("act_batch", self.mesh, self.rules)
        return sharding.axis_group(self.mesh, axes) if axes else None

    def token_group(self):
        """The group of the mesh dims that split a batch of ``batch``
        sequences (its ``"act_batch"`` entry), or None where they leave
        it whole: the ranks whose tokens together are the batch."""
        if self.batch is None:
            raise ValueError("the mixture of experts routes the whole "
                             "batch: Parallel needs its size (batch=)")
        axes = sharding.spec_for((self.batch,), ("act_batch",), self.mesh,
                                 self.rules)[0]
        return None if axes is None else sharding.axis_group(self.mesh,
                                                             axes)

    def grad_groups(self, spec: SpecTree) -> tuple[list, Any]:
        """For the parameters the spec tree ``spec`` declares, in leaf
        order: the group over the batch's mesh dims a parameter's spec
        does not split it over (its gradient there is a partial sum over
        the batch blocks, to be folded), or None; and the tree of the
        clip's groups (:func:`~repro_torch.train.optim.global_norm`), each
        leaf's over every mesh dim its spec splits it over, or None."""
        batch_axes, _ = sharding.mesh_extent("act_batch", self.mesh,
                                             self.rules)

        def group(axes):
            return sharding.axis_group(self.mesh, axes) if axes else None

        split = [tuple(a for axes in self.spec(p) if axes is not None
                       for a in ((axes,) if isinstance(axes, str) else axes))
                 for p in leaves(spec)]
        folds = [group(tuple(a for a in batch_axes if a not in s))
                 for s in split]
        norm = iter([group(s) for s in split])
        return folds, tree_map(lambda _: next(norm), spec, _is_p)

    def gather(self, w: torch.Tensor, p: P) -> torch.Tensor:
        """``w``, this rank's block of ``p``, with its ``"embed"`` dim whole
        again (FSDP: gathered right before each use, as GSPMD does per
        layer); its other dims as they are."""
        if "embed" in p.axes:
            g = self.group(p, "embed")
            if g is not None:
                w = sharding.all_gather_cat(w, g, p.axes.index("embed"))
        return w


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-6) -> torch.Tensor:
    """float32 statistics; the scaling in ``x``'s dtype."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric when weight and bias are None. float32 mean and
    population variance; ``(x - mu) * rsqrt(var + eps)`` in ``x``'s dtype
    (not ``F.layer_norm``, which rounds once at the end)."""
    var, mu = torch.var_mean(x.to(torch.float32), dim=-1, correction=0,
                             keepdim=True)
    out = (x - mu.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def apply_norm(x: torch.Tensor, params: dict | None, kind: str
               ) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"] if params else None)
    if kind == "layernorm":
        return layer_norm(x, params["scale"] if params else None,
                          params.get("bias") if params else None)
    if kind == "nonparametric_ln":
        return layer_norm(x, None, None)
    raise ValueError(kind)


def norm_spec(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": P((d,), ("norm",), "ones")}
    if kind == "layernorm":
        return {"scale": P((d,), ("norm",), "ones"),
                "bias": P((d,), ("norm",), "zeros")}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: (..., S). Rotates the split
    halves (not interleaved pairs) with float32 angles, then casts back."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_spec(vocab: int, d: int) -> dict:
    return {"embedding": P((vocab, d), ("vocab", "embed"), "normal", 0.02)}


def embed(params: dict, tokens: torch.Tensor, compute_dtype: torch.dtype,
          par: Parallel | None = None, vocab: int = 0,
          d: int = 0) -> torch.Tensor:
    """The rows of ``tokens`` ``(b, s)`` in the compute dtype: the
    reference's ``jnp.take`` of the table cast to it. ``F.embedding``,
    whose CUDA backward pass sorts the indices and adds colliding rows in
    a fixed order (not ``index_select``'s atomics).

    With ``par``, ``params`` is this rank's block of the ``(vocab, d)``
    table: its ``embed`` dim is gathered (FSDP), the tokens in this
    rank's block ``[lo, hi)`` of the ``vocab`` dim take its rows and the
    others zeros, and the blocks are folded over the vocab's group
    (:func:`~repro_torch.distributed.sharding.fold_partials`). Each token
    has one nonzero row, so the result is bitwise the unsharded lookup,
    the same on every rank of the group."""
    w = params["embedding"]
    idx = tokens.to(torch.int64)
    group = None
    if par is not None:
        decl = embed_spec(vocab, d)["embedding"]
        w = par.gather(w, decl)
        group = par.group(decl, "vocab")
    if group is None:
        return torch.nn.functional.embedding(idx, w).to(compute_dtype)
    lo, hi = sharding.local_range(vocab, group)
    here = (idx >= lo) & (idx < hi)
    rows = torch.nn.functional.embedding(torch.where(here, idx - lo, 0), w)
    rows = torch.where(here[..., None], rows, rows.new_zeros(()))
    return sharding.fold_partials(rows, group).to(compute_dtype)


# ---------------------------------------------------------------------------
# Unembedding
# ---------------------------------------------------------------------------

def unembed_spec(vocab: int, d: int) -> dict:
    return {"kernel": P((d, vocab), ("embed", "vocab"))}


def unembed(params: dict, x: torch.Tensor, compute_dtype: torch.dtype,
            par: Parallel | None = None, vocab: int = 0) -> torch.Tensor:
    """Logits; with ``par``, this rank's block of the ``vocab`` columns
    (all of them where :func:`~repro_torch.distributed.sharding.spec_for`
    leaves the vocab whole), ``x`` entering the vocab's group."""
    w = params["kernel"]
    if par is not None:
        decl = unembed_spec(vocab, x.shape[-1])["kernel"]
        x = par.enter(x, decl, "vocab")
        w = par.gather(w, decl)
    return x.to(compute_dtype) @ w.to(compute_dtype)


def true_divide(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as a true division in ``x``'s dtype. A Python scalar
    divisor becomes a multiplication by its reciprocal on the card (one
    bit less exact); a 0-d tensor divisor divides on every device."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


def count_params(tree) -> int:
    """Elements in a tree of tensors or of :class:`P` declarations."""
    return sum(math.prod(leaf.shape) for leaf in leaves(tree))


def leaves(tree) -> list:
    """The leaves of nested dicts and lists, in the reference's order."""
    out: list = []
    tree_map(out.append, tree, _is_p)
    return out
