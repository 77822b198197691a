"""Fault-tolerant checkpointing on PyTorch. Twin of ``repro.ckpt.checkpoint``.

* **Atomic**: write to ``step_N.tmp/``, fsync, rename to ``step_N/`` — a
  crash mid-write never corrupts the latest valid checkpoint.
* **Keep-K**: older steps and orphaned ``.tmp`` directories are removed
  after every save.
* **Async**: :class:`AsyncCheckpointer` copies every leaf to the host
  before ``save`` returns, then writes on a daemon thread.
* **Preemption-safe**: :func:`install_preemption_handler` saves on SIGTERM.

The on-disk format is the reference's, byte for byte: one ``.npy`` per
leaf and a ``MANIFEST.json`` with ``step``, ``time``, ``extra`` and
``leaves`` in a ``step_%010d`` directory. Leaves are named as the
reference's ``jax.tree_util`` paths name them — a dict key ``k`` becomes
``(k)`` and a list or tuple index ``i`` becomes ``(i)``, dict keys taken
in sorted order and ``None`` holding no leaf — so a checkpoint written by
either package is read by the other. The trees are dicts, lists and
tuples of tensors, numpy arrays and Python scalars, flattened here.
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


def _children(tree) -> list[tuple[str, Any]] | None:
    """``[(path key, child), ...]`` of a container node (``None`` for a
    leaf), in the reference's flattening order."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
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


def restore(ckpt_dir: str, like, *, step: int | None = None,
            device: str | torch.device | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` as tensors on ``device``
    (the CPU when None). Each leaf's shape must be its ``like`` leaf's.
    Returns ``(tree, manifest extra)``."""
    d, manifest = _step_dir(ckpt_dir, step)
    out = []
    for name, leaf in _flatten_with_paths(like):
        arr = np.load(os.path.join(d, name + ".npy"))
        want_shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{name}: ckpt {arr.shape} != {want_shape}")
        out.append(torch.from_numpy(arr).to(device or "cpu"))
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


def install_preemption_handler(save_fn: Callable[[], None]) -> None:
    """Save a checkpoint on SIGTERM (cluster preemption) before exit."""
    def handler(signum, frame):
        save_fn()
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, handler)
