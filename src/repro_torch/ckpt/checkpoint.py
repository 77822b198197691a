"""Fault-tolerant checkpointing on PyTorch. Twin of ``repro.ckpt.checkpoint``.

* **Atomic**: write to ``step_N.tmp/``, fsync, rename to ``step_N/`` — a
  crash mid-write never corrupts the latest valid checkpoint.
* **Keep-K**: older steps and orphaned ``.tmp`` directories are removed
  after every save.
* **Async**: :class:`AsyncCheckpointer` copies every leaf to the host
  before ``save`` returns, then writes on a daemon thread.
* **Preemption-safe**: :func:`install_preemption_handler` saves on SIGTERM.
* **Elastic**: :func:`restore` with ``specs`` and ``mesh`` cuts each
  rank's blocks from the whole leaves; :class:`MeshCheckpointer` writes a
  sharded state whole, from rank 0, so a relaunch may take another mesh.

The on-disk format is the reference's, byte for byte: one ``.npy`` per
leaf and a ``MANIFEST.json`` with ``step``, ``time``, ``extra`` and
``leaves`` in a ``step_%010d`` directory. Leaves are named as the
reference's ``jax.tree_util`` paths name them — a dict key ``k`` becomes
``(k)``, a list or tuple index ``i`` becomes ``(i)`` and a NamedTuple's
field ``f`` becomes ``.f``, dict keys taken in sorted order and ``None``
holding no leaf — so a checkpoint written by either package is read by
the other: a training state ``(params, AdamWState)`` has the leaves
``(0)...``, ``(1).step``, ``(1).mu...`` and ``(1).nu...`` in both. The
trees are dicts, lists, tuples and NamedTuples of tensors, numpy arrays
and Python scalars, flattened here.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (local_block, map_blocks,
                                              whole_block)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """``[(path key, child), ...]`` of a container node (``None`` for a
    leaf), in the reference's flattening order: a NamedTuple's fields by
    name (JAX's ``GetAttrKey``), a list's or plain tuple's by index."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [leaf for key, child in kids
            for leaf in _flatten(child, prefix + key)]


def _flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """``[(file-safe leaf name, leaf), ...]``, named as the reference names
    them (its ``keystr`` path through the same filename sanitizer)."""
    return [(path.replace("/", "_").replace("'", "").replace("[", "(")
             .replace("]", ")"), leaf) for path, leaf in _flatten(tree)]


def _unflatten(like, leaves):
    """Rebuild the structure of ``like`` from an iterator over leaves."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*[_unflatten(x, leaves) for x in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _host_copy(leaf) -> np.ndarray:
    """A host numpy copy of ``leaf`` that owns its memory: a later in-place
    update of the source (on the card or on the CPU) cannot reach it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra: dict | None = None) -> str:
    """Synchronous atomic checkpoint. Returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "time": time.time(),
                "extra": extra or {}, "leaves": {}}
    for name, leaf in _flatten_with_paths(tree):
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {"shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic on POSIX
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    for d in os.listdir(ckpt_dir):          # orphaned tmp dirs from crashes
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete step in ``ckpt_dir`` (None if none, or no
    directory)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "MANIFEST.json"))]
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: int | None) -> tuple[str, dict]:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return d, json.load(f)


def _spec_leaves(tree, specs) -> list:
    """The spec at each leaf of ``tree``, in :func:`_flatten`'s order, from
    ``specs``, a tree of the same structure with a spec (a tuple, see
    :func:`~repro_torch.distributed.sharding.spec_for`) at every leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [specs]
    if isinstance(tree, dict):
        return [s for k in sorted(tree)
                for s in _spec_leaves(tree[k], specs[k])]
    return [s for (_, child), spec in zip(kids, specs, strict=True)
            for s in _spec_leaves(child, spec)]


def restore(ckpt_dir: str, like, *, step: int | None = None,
            device: str | torch.device | None = None, specs=None,
            mesh=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` as tensors on ``device``
    (the CPU when None). Each leaf's shape must be its ``like`` leaf's
    (meta tensors will do). Returns ``(tree, manifest extra)``.

    With ``specs`` (a tree of ``like``'s structure with a spec at every
    leaf, as a cell's ``in_shardings``) and ``mesh``, the elastic restore
    (the reference's ``shardings=``): every rank reads each whole array
    and keeps its own block of it
    (:func:`~repro_torch.distributed.sharding.local_block`) on
    ``device``, a leaf at a time. The checkpoint may have been written
    unsharded, on any mesh, or by the reference: its leaves are whole."""
    d, manifest = _step_dir(ckpt_dir, step)
    leaf_specs = (_spec_leaves(like, specs) if specs is not None
                  else [None] * len(_flatten(like)))
    out = []
    for (name, leaf), spec in zip(_flatten_with_paths(like), leaf_specs,
                                  strict=True):
        arr = np.load(os.path.join(d, name + ".npy"))
        want_shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{name}: ckpt {arr.shape} != {want_shape}")
        t = torch.from_numpy(arr).to(device or "cpu")
        out.append(t if spec is None else local_block(t, spec, mesh))
    return _unflatten(like, iter(out)), manifest["extra"]


def restore_tree(ckpt_dir: str, *, step: int | None = None
                 ) -> tuple[dict, dict]:
    """Restore a checkpoint WITHOUT a ``like`` tree.

    For state whose leaf set varies run to run (the fleet service's
    parked-slot pool and per-sensor capture logs). The checkpoint must have
    been saved from a single-level ``dict``; returns ``({key: np.ndarray},
    manifest extra)`` with the dict keys recovered from the leaf names.
    """
    d, manifest = _step_dir(ckpt_dir, step)
    leaves = {}
    for name in manifest["leaves"]:
        # single-level dict keys encode as "(key)" — undo exactly that
        key = name[1:-1] if name.startswith("(") and name.endswith(")") \
            else name
        leaves[key] = np.load(os.path.join(d, name + ".npy"))
    return leaves, manifest["extra"]


class AsyncCheckpointer:
    """Snapshot to the host, then write on a daemon thread; at most one
    write in flight, and its error is raised by the next :meth:`wait`."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        """Block until the write in flight is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        """Copy every leaf of ``tree`` to the host now (a blocking copy from
        the card: the next step may update the tensors in place), then write
        it in the background."""
        self.wait()                       # one in flight
        names = _flatten(tree)
        host_tree = _unflatten(tree, iter(_host_copy(leaf)
                                          for _, leaf in names))

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, keep=self.keep,
                     extra=extra)
            except BaseException as e:    # noqa: BLE001 - re-raised by wait
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()


class MeshCheckpointer:
    """The train loop's checkpoints of a state sharded over ``mesh``, each
    rank holding its blocks under ``specs`` (a tree of the state's
    structure with a spec at every leaf), or whole on this process where
    ``mesh`` is None. On a mesh a save is a collective: every rank
    gathers the whole tree (:func:`~repro_torch.distributed.sharding.
    whole_block`, in group-rank order), and rank 0 alone writes it, in
    the format of :func:`save`, so any mesh, the unsharded loop or the
    reference reads it; rank 0 alone applies ``keep``. The other ranks
    never write into ``ckpt_dir``. :meth:`save` writes in the background
    (:class:`AsyncCheckpointer`); :meth:`save_now` waits for that write,
    writes, and returns on every rank once the checkpoint is on disk (a
    barrier over ``group``, a process group of the mesh's ranks)."""

    def __init__(self, ckpt_dir: str, keep: int = 3, specs=None, mesh=None,
                 group=None):
        self.specs, self.mesh, self.group = specs, mesh, group
        self.ckpt_dir, self.keep = ckpt_dir, keep
        self.writer = (AsyncCheckpointer(ckpt_dir, keep)
                       if mesh is None or dist.get_rank() == 0 else None)

    def whole(self, blocks):
        return map_blocks(whole_block, blocks, self.specs, self.mesh)

    def _tree(self, blocks):
        return blocks if self.mesh is None else self.whole(blocks)

    def save(self, step: int, blocks, extra: dict | None = None) -> None:
        whole = self._tree(blocks)
        if self.writer is not None:
            self.writer.save(step, whole, extra)

    def save_now(self, step: int, blocks, extra: dict | None = None) -> None:
        whole = self._tree(blocks)
        if self.writer is not None:
            self.writer.wait()
            save(self.ckpt_dir, step, whole, keep=self.keep, extra=extra)
        del whole
        if self.mesh is not None:
            dist.barrier(group=self.group)


def install_preemption_handler(save_fn: Callable[[], None]) -> None:
    """Save a checkpoint on SIGTERM (cluster preemption) before exit."""
    def handler(signum, frame):
        save_fn()
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, handler)
