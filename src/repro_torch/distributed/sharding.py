"""Logical-axis sharding rules on ``torch.distributed``. Twin of
``repro.distributed.sharding``.

Every tensor dimension carries a *logical* name; a rules table maps
logical names to mesh dimensions. The sensor fleet
(:mod:`repro_torch.sensing.fleet`, :mod:`repro_torch.launch.serve`) rides
the table as a 2-D logical mesh: ``"sensors"`` partitions the stream axis
over the data dimensions (:func:`mesh_extent` reports the raw extent, so
the fleet can PAD a non-divisible S with masked slots) and ``"hyperdim"``
partitions the scorers' D-tile axis over ``"model"`` (:func:`spec_for`
drops it when the tile count does not divide: the tiles are then
replicated, never padded).

The rule functions read only a mesh's dimension names and sizes, so they
take a ``torch.distributed.device_mesh.DeviceMesh`` with named dimensions
or a plain ``{name: size}`` mapping. A spec is a tuple with one entry per
tensor dimension: a mesh dimension's name, a tuple of names, or None
(replicated). The runtime helpers work on the process groups of a
``DeviceMesh``: :func:`axis_group` (over one mesh dim or several),
:func:`local_range`, :func:`local_block` (this rank's block of a whole
tensor) and :func:`whole_block` (the blocks back together), each over a
tree by :func:`map_blocks`,
:func:`all_gather_cat` (the blocks back together, in rank order),
:func:`gather_alike` (the same, for a computation every rank then runs
alike), :func:`fold_partials` (the partial sums of a row-parallel product added
in rank order, in float32), :func:`enter_group` (a replicated activation
entering a column-parallel product) and :func:`max_over`;
:func:`count_collectives` records the bytes they move. The detector's and
the cells' sharded steps (:mod:`repro_torch.models`,
:mod:`repro_torch.launch.steps`) are written out with them, as there is
no GSPMD to insert its collectives.

Autograd differentiates the collectives, each backward pass in a fixed
order, so every rank and every run gets the same bits: the gather's is a
reduce-scatter (an all-to-all, then the blocks added in group-rank order
in float32), the fold's the identity (its output is the same on every
rank of the group), and :func:`enter_group`'s a fold (Megatron's "f" and
"g"). None of them uses ``all_reduce`` or ``reduce_scatter``, whose order
is the algorithm NCCL picks.

:func:`logical_sharding` is the spec a cell's inputs and outputs carry
(the train and prefill cells of :mod:`repro_torch.launch.steps`).

Not ported yet: ``shard``, the LM models' activation constraints (the
sequence-parallel residual among them), which GSPMD reads and the
port's written-out forward has no use for.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from typing import Iterator, Mapping, Sequence

import torch
import torch.distributed as dist

_CTX = threading.local()


# Default rules for the production meshes (("pod",) "data", "model").
# Weights: TP dims over "model", FSDP dim over "data".
# Activations: batch over ("pod","data"); TP'd feature dims over "model".
DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    # --- weight dims ---
    "embed": ("pod", "data"),    # FSDP/ZeRO-3: gathered per-layer under
                                 # scan; spans pods on the multi-pod mesh
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv_dim": None,
    "head_dim": None,
    "vocab": ("model",),
    "expert": ("model",),        # expert parallelism
    "expert_mlp": ("model",),    # fallback when n_experts can't take it
                                 # (e.g. grok's 8 experts on a 16-wide axis)
    "ssm_inner": ("model",),
    "ssm_state": None,
    "ssm_heads": ("model",),
    "conv_dim": ("model",),
    "conv_k": None,
    "layers": None,              # scan axis — never sharded
    "norm": None,
    # --- activation dims ---
    "act_batch": ("pod", "data"),
    # Sensor-fleet axis (repro_torch.sensing.fleet): independent streams,
    # so it shards like a batch — data-parallel over pods/hosts, never
    # "model".
    "sensors": ("pod", "data"),
    # Hypervector-dimension axis (repro_torch.kernels.sliding_scores*): the
    # HDC dot products and norms are sums over D, so the D-tile axis (n_dt)
    # partitions like a TP feature dim over "model". Each rank holds a
    # contiguous shard of class tiles + slabs; the cosine epilogue's fold
    # runs after an all_gather that restores global tile order, so sharded
    # scores are bitwise-identical to unsharded.
    "hyperdim": ("model",),
    "act_seq": None,
    # Megatron-style sequence parallelism for the residual stream: layer
    # boundaries are sharded along sequence over "model", shrinking saved
    # residuals by the TP degree.
    "act_resid_seq": ("model",),
    "cache_seq": ("model",),     # used only when kv_heads can't take "model"
    "act_expert_cap": ("model",),  # MoE buffer cap dim when experts can't
    "act_embed": None,
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_expert": ("model",),
    "act_ssm_heads": ("model",),
    "act_state": None,
}

#: logical names that claim mesh dims BEFORE fallback dims (e.g. the KV-head
#: dim outranks "cache_seq"; the expert dim outranks "act_expert_cap") —
#: fallbacks only shard when the preferred dim couldn't (non-divisible).
PRIORITY_NAMES = ("act_kv_heads", "act_heads", "act_expert", "expert",
                  "kv_heads", "heads", "act_ssm_heads")


@contextmanager
def use_mesh(mesh, rules: dict | None = None) -> Iterator:
    """Make ``mesh`` (and ``rules`` over :data:`DEFAULT_RULES`) the current
    mesh inside the scope; on exit, exceptions included, the previous one
    is current again."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, dict(DEFAULT_RULES, **(rules or {})))
    try:
        yield mesh
    finally:
        _CTX.state = prev


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` scope, or None."""
    state = getattr(_CTX, "state", None)
    return state[0] if state else None


def current_rules() -> dict:
    state = getattr(_CTX, "state", None)
    return state[1] if state else dict(DEFAULT_RULES)


def mesh_shape(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a named ``DeviceMesh``, or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions need names "
                         "(init_device_mesh(..., mesh_dim_names=...))")
    return dict(zip(names, (int(n) for n in mesh.mesh.shape)))


def _mapped(logical: str | None, rules: dict) -> tuple[str, ...]:
    mapped = None if logical is None else rules.get(logical)
    if mapped is None:
        return ()
    return (mapped,) if isinstance(mapped, str) else tuple(mapped)


def mesh_extent(logical: str, mesh=None, rules: dict | None = None
                ) -> tuple[tuple[str, ...], int]:
    """Mesh dims a logical name maps to, ignoring divisibility.

    Returns ``(axes, k)``: the dims of ``mesh`` the rules map ``logical``
    to, and the product of their sizes (1 when unmapped or without a
    mesh). Unlike :func:`spec_for`, this keeps dims whose size does not
    divide a tensor dim: callers *pad* that dim to a multiple of ``k``
    (the fleet pads its sensor axis with masked slots).
    """
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return (), 1
    shape = mesh_shape(mesh)
    out = tuple(ax for ax in _mapped(logical, rules) if ax in shape)
    k = 1
    for ax in out:
        k *= shape[ax]
    return out, k


def padded_extent(n: int, logical: str, mesh=None,
                  rules: dict | None = None) -> int:
    """Smallest multiple of ``logical``'s mesh extent that is >= ``n``
    (at least one): the slot pool's size rule. Without a mesh this is the
    identity."""
    _, k = mesh_extent(logical, mesh, rules)
    return -(-max(n, 1) // k) * k


def _axis_for(logical: str | None, rules: dict, shape: Mapping[str, int],
              dim_size: int, taken: set) -> tuple[str, ...] | None:
    """One logical dim -> mesh dims, dropping dims that are missing, taken
    already, or whose size (times the ones kept) does not divide
    ``dim_size``: such a dim stays replicated rather than erroring."""
    out = []
    prod = 1
    for ax in _mapped(logical, rules):
        if ax not in shape or ax in taken:
            continue
        n = shape[ax]
        if dim_size % (prod * n) != 0:
            continue
        out.append(ax)
        prod *= n
    return tuple(out) or None


def spec_for(shape: Sequence[int], axes: Sequence[str | None], mesh=None,
             rules: dict | None = None) -> tuple:
    """The spec of a tensor of ``shape`` with logical ``axes``: one entry
    per dim (a mesh dim's name, a tuple of names, or None).

    Two passes: the priority names first (so e.g. "act_kv_heads" claims
    "model" when divisible), then the other dims in order. Without a mesh
    every entry is None.
    """
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules()
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    parts: list = [None] * len(shape)
    if mesh is None:
        return tuple(parts)
    mshape = mesh_shape(mesh)
    taken: set = set()
    order = ([i for i, n in enumerate(axes) if n in PRIORITY_NAMES]
             + [i for i, n in enumerate(axes) if n not in PRIORITY_NAMES])
    for i in order:
        resolved = _axis_for(axes[i], rules, mshape, shape[i], taken)
        if resolved:
            taken.update(resolved)
            parts[i] = resolved if len(resolved) > 1 else resolved[0]
    return tuple(parts)


def logical_sharding(shape: Sequence[int], axes: Sequence[str | None],
                     mesh=None, rules: dict | None = None) -> tuple | None:
    """The sharding of a tensor of ``shape`` with logical ``axes`` on
    ``mesh`` (or the current one): the twin of the reference's
    ``logical_sharding``. In the port a sharding is the :func:`spec_for`
    tuple; None without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return spec_for(shape, axes, mesh, rules)


# ---------------------------------------------------------------------------
# Runtime: process groups, this rank's slice, the gather
# ---------------------------------------------------------------------------

def axis_group(mesh, axes: str | Sequence[str]):
    """The process group of ``mesh``'s dims ``axes`` (a spec entry: one
    name or a tuple of names) that holds this rank: the ranks that differ
    from it along those dims alone. Over several dims the group's ranks
    run in the mesh's row-major order of those dims (for ``("pod",
    "data")``: pod-major), whatever order ``axes`` names them in; every
    rank makes every such group of the mesh (``dist.new_group``, one per
    row, in the same order) the first time it asks for those dims, and
    the mesh keeps them."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh_shape(mesh))
    dims = sorted(names.index(a) for a in axes)
    key = tuple(names[i] for i in dims)
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if key not in cache:
        rest = [i for i in range(len(names)) if i not in dims]
        k = math.prod(mesh.mesh.shape[i] for i in dims)
        me = dist.get_rank()
        for row in mesh.mesh.permute(*rest, *dims).reshape(-1, k).tolist():
            group = dist.new_group(row)
            if me in row:
                cache[key] = group
    return cache[key]


def local_range(n: int, group) -> tuple[int, int]:
    """``(lo, hi)``: this rank's contiguous block of a dim of size ``n``
    split evenly over ``group``, in group-rank order (the order in which
    :func:`all_gather_cat` puts the blocks back together)."""
    k = dist.get_world_size(group)
    if n % k:
        raise ValueError(f"a dim of {n} does not split over {k} ranks")
    r = dist.get_rank(group)
    return r * (n // k), (r + 1) * (n // k)


def local_block(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's contiguous block of the whole tensor ``t`` along every
    dim that ``spec`` (from :func:`spec_for`) shards: along each, the
    :func:`local_range` of the dim's group, in group-rank order, which is
    the order :func:`all_gather_cat` restores. A fresh tensor, so ``t``
    can be freed."""
    if len(spec) != t.ndim:
        raise ValueError(f"spec {tuple(spec)} does not fit a tensor of "
                         f"shape {tuple(t.shape)}")
    for dim, axes in enumerate(spec):
        if axes is not None:
            lo, hi = local_range(t.shape[dim], axis_group(mesh, axes))
            t = t.narrow(dim, lo, hi - lo)
    return t.clone(memory_format=torch.contiguous_format)


def whole_block(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's :func:`local_block`
    under ``spec``: gathered in group-rank order along every dim that
    ``spec`` shards (the same on every rank of those groups)."""
    if len(spec) != t.ndim:
        raise ValueError(f"spec {tuple(spec)} does not fit a tensor of "
                         f"shape {tuple(t.shape)}")
    with torch.no_grad():
        for dim, axes in enumerate(spec):
            if axes is not None:
                t = all_gather_cat(t, axis_group(mesh, axes), dim)
    return t


def map_blocks(fn, tree, specs, mesh):
    """``fn(tensor, spec, mesh)`` at every tensor of ``tree`` (nested
    dicts, lists and tuples, NamedTuples among them) and its spec in the
    tree ``specs`` of the same structure; None stays None. With
    :func:`local_block` it cuts a whole tree into this rank's blocks, with
    :func:`whole_block` it puts them back together."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: map_blocks(fn, tree[k], specs[k], mesh) for k in tree}
    parts = [map_blocks(fn, t, s, mesh) for t, s in zip(tree, specs)]
    return type(tree)(*parts) if hasattr(tree, "_fields") \
        else type(tree)(parts)


@dataclasses.dataclass
class CollectiveCount:
    """What the helpers' collectives moved inside a
    :func:`count_collectives` scope, keyed by the reference's HLO op names
    (``repro.distributed.roofline._COLL_OPS``): ``bytes``, each
    collective's output payload summed (the reference's
    ``collective_bytes`` sums output shapes, too), and ``calls``."""
    bytes: dict = dataclasses.field(default_factory=dict)
    calls: dict = dataclasses.field(default_factory=dict)


# the open count_collectives scopes: process-wide, since autograd runs a
# CUDA backward pass (and a remat layer's recompute) on its own threads
_COUNTS: list[CollectiveCount] = []
_COUNTS_LOCK = threading.Lock()


@contextmanager
def count_collectives() -> Iterator[CollectiveCount]:
    """Record the collectives the helpers issue inside the scope, in any
    thread of the process (every open scope records them), the backward
    passes' included: the port's counterpart of the reference's HLO parse
    (``roofline.collective_bytes``), which has no meaning without XLA. A
    collective is recorded where Python issues it, so a CUDA graph's
    replay records nothing: count over an uncaptured run."""
    count = CollectiveCount()
    with _COUNTS_LOCK:
        _COUNTS.append(count)
    try:
        yield count
    finally:
        with _COUNTS_LOCK:
            _COUNTS.remove(count)


def _record(op: str, n_bytes: int) -> None:
    with _COUNTS_LOCK:
        for count in _COUNTS:
            count.bytes[op] = count.bytes.get(op, 0) + n_bytes
            count.calls[op] = count.calls.get(op, 0) + 1


def _gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` of ``group``, in group-rank order
    (``dist.all_gather``, which every torch version and backend has; NCCL
    enqueues it on the card's stream, with no host wait)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    _record("all-gather", len(parts) * x.numel() * x.element_size())
    return parts


def _ordered_sum(parts, dtype: torch.dtype) -> torch.Tensor:
    """``parts`` added in their order in float32, cast to ``dtype``."""
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc.to(dtype)


def _fold(x: torch.Tensor, group) -> torch.Tensor:
    return _ordered_sum(_gather(x, group), x.dtype)


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group`` of every
    rank's ``g``: each rank sends every rank its block
    (``dist.all_to_all_single``), and the blocks received are added in
    group-rank order in float32, then cast back to ``g``'s dtype."""
    k = dist.get_world_size(group)
    send = torch.stack(g.chunk(k, dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _record("all-to-all", recv.numel() * recv.element_size())
    return _ordered_sum(recv.unbind(0), g.dtype)


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(_gather(x, group), dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _GatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return torch.cat(_gather(x, group), dim)

    @staticmethod
    def backward(ctx, grad):
        lo = dist.get_rank(ctx.group) * ctx.n
        return grad.narrow(ctx.dim, lo, ctx.n).contiguous(), None, None


class _Fold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _fold(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _fold(grad, ctx.group), None


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in
    group-rank order. Its backward pass gives each rank its block of the
    sum of every rank's gradient (:func:`_reduce_scatter`): an FSDP
    weight's gradient, summed over the ranks that gathered it."""
    return _GatherCat.apply(x, group, dim)


def gather_alike(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in
    group-rank order, as :func:`all_gather_cat`, for a computation that
    every rank of the group then runs alike on the whole (the same inputs,
    the same products): each rank's gradient of the whole is then the
    same, so the backward pass keeps this rank's block of it, with no
    communication (a sum over the ranks would count it once a rank)."""
    return _GatherAlike.apply(x, group, dim)


def fold_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's partial ``x`` (a row-parallel
    product's), cast back to ``x``'s dtype: gathered, then added in
    group-rank order in float32 (the scorers' ``_ordered_tile_fold``
    discipline). Not ``dist.all_reduce``, whose order is the algorithm
    NCCL picks: this fold is the same bits on every rank and from run to
    run. On a one-rank group it is ``x`` itself. Its backward pass is the
    identity: the output is the same on every rank, so each partial's
    gradient is the output's."""
    return _Fold.apply(x, group)


def enter_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, a value the same on every rank of ``group`` that feeds a
    product split over ``group`` (a column-parallel weight's out-dim):
    the identity forward; backward, the ranks' partial gradients of
    ``x`` folded (:func:`fold_partials`), so every rank holds the whole
    gradient."""
    return _Enter.apply(x, group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` over ``group``, with
    no gradient (a logsumexp's shift)."""
    return torch.stack(_gather(x.detach(), group)).amax(0)
