"""Runtime sanitizer harness: ``REPRO_SANITIZE=1`` turns the suite hostile.

The port's twin of ``repro.analysis.sanitize``, with the same names. Three
independent checks, all zero-cost when disabled:

* **Global checks** (:func:`install_global_checks`):
  ``torch.autograd.set_detect_anomaly(True)`` (a NaN out of a backward
  function raises, naming the forward op that made it) and a
  ``TorchDispatchMode`` that raises at the first op whose floating output
  holds a NaN, naming the op. It reads every output on the host, so it is
  armed only when asked. The reference's ``jax_check_tracer_leaks`` has
  no eager counterpart: there is no trace for a value to leak out of.

* **Transfer guard** (:func:`no_implicit_transfers`): on the card,
  ``torch.cuda.set_sync_debug_mode("error")``, so any op that waits for
  the device raises, naming it. On a host without CUDA (the CPU tests) a
  ``TorchFunctionMode`` that models the card. A tensor made inside the
  guarded block lies "on the device" unless it was made from numpy, by a
  factory given no device (or ``device="cpu"``), by ``.cpu()`` or
  ``.to("cpu")``, or from host tensors only; ``.item()``, ``.tolist()``,
  ``.numpy()``, ``bool``/``int``/``float``/``np.asarray`` and the
  data-shaped ops (``nonzero``, ``masked_select``, ``unique``,
  ``argwhere``) on such a tensor raise. **Limit:** a tensor made before
  the block counts as host memory (the guard cannot know where it was
  meant to lie), so it sees the implicit reads of what the guarded
  region computes — a tick's scores, maps and folds — not of carried
  weights. The runtime twin of lint rule RA003.

* **Rebuild ledger** (:class:`RebuildLedger` / :func:`steady_state`): a
  process-wide monotone counter of rebuild events — a kernel library
  built or first loaded by ``kernels/_build.py``, a CUDA graph captured,
  a service's tiles, rings or graph built (the sites that count a
  service's ``rebuild_count()``). ``steady_state()`` asserts a region
  records **zero** of them: the contract every post-warmup serving loop
  sells (the runtime twin of RA005).
"""

from __future__ import annotations

import contextlib
import os
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

_ENV = "REPRO_SANITIZE"


def enabled() -> bool:
    return os.environ.get(_ENV, "").strip() not in ("", "0", "false", "no")


class RebuildLedger:
    """Monotone counter of rebuild events for the whole process."""

    def __init__(self):
        self.events = 0
        self.last = ""
        self._installed = False

    def note(self, what: str) -> None:
        self.events += 1
        self.last = what

    def install(self):
        """Count CUDA graph captures too (every ``torch.cuda.graph`` and
        ``make_graphed_callables`` begins one with ``capture_begin``)."""
        if self._installed:
            return self
        graph = getattr(getattr(torch.cuda, "graphs", None), "CUDAGraph", None)
        if graph is not None:
            begin = graph.capture_begin

            def capture_begin(g, *args, **kwargs):
                self.note("CUDA graph capture")
                return begin(g, *args, **kwargs)
            graph.capture_begin = capture_begin
        self._installed = True
        return self

    @contextlib.contextmanager
    def expect_no_rebuilds(self, what="steady-state region"):
        before = self.events
        yield self
        grew = self.events - before
        if grew:
            raise AssertionError(
                "rebuild ledger: %s recorded %d rebuild event(s) (last: %s); "
                "steady-state loops must reuse every built graph, buffer and "
                "kernel library (lint rule RA005 is the static twin of this "
                "check)" % (what, grew, self.last)
            )


_LEDGER = RebuildLedger()


def ledger() -> RebuildLedger:
    """The process-wide ledger, hooking graph captures on first use."""
    return _LEDGER.install()


def note_rebuild(what: str) -> None:
    """Record one rebuild event (a cheap counter bump at each build site)."""
    _LEDGER.note(what)


def steady_state(what="steady-state region"):
    """``with steady_state():`` asserts zero rebuild events inside."""
    return ledger().expect_no_rebuilds(what)


# ---------------------------------------------------------------------------
# the transfer guard
# ---------------------------------------------------------------------------

_T = torch.Tensor
_IMPLICIT = {_T.item: "item()", _T.tolist: "tolist()", _T.numpy: "numpy()",
             _T.__bool__: "bool()", _T.__int__: "int()", _T.__float__: "float()",
             _T.__complex__: "complex()", _T.__index__: "__index__()",
             _T.__array__: "np.asarray()"}
_DATA_SHAPE = {torch.nonzero, _T.nonzero, torch.argwhere, _T.argwhere,
               torch.masked_select, _T.masked_select, torch.unique, _T.unique,
               torch.unique_consecutive, _T.unique_consecutive}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _cpu(x) -> bool:
    return isinstance(x, str) and x == "cpu"


class _HostReadGuard(TorchFunctionMode):
    """Raise at an implicit host read of a tensor that would lie on the
    card (the CPU stand-in for ``set_sync_debug_mode("error")``)."""

    def __init__(self):
        super().__init__()
        self._device = {}  # id -> weakref of tensors made "on the device"

    def _on_device(self, t) -> bool:
        r = self._device.get(id(t))
        return r is not None and r() is t

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        name = _IMPLICIT.get(func)
        if name is None and func in _DATA_SHAPE:
            name = getattr(func, "__name__", str(func)) + "()"
        if name is not None and any(self._on_device(t) for t in ins):
            raise RuntimeError(
                "implicit host read: %s on a tensor that lies on the device "
                "(use .cpu() at a designed sync point)" % name)
        out = func(*args, **kwargs)
        if func is _T.cpu or (func is _T.to and (
                any(_cpu(a) for a in args) or _cpu(kwargs.get("device")))):
            for t in _tensors(out):  # on this host, often the input itself
                self._device.pop(id(t), None)
            return out
        if func in (_T.to, _T.cuda):
            device = any(self._on_device(t) for t in ins) or "device" in kwargs \
                or any(isinstance(a, (str, torch.device)) for a in args[1:])
        elif ins:
            device = any(self._on_device(t) for t in ins)
        else:  # a factory: on the device when given one other than "cpu"
            device = kwargs.get("device") is not None and not _cpu(kwargs["device"])
        if device:
            for t in _tensors(out):
                if not any(t is i for i in ins):  # not an input written in place
                    key = id(t)
                    self._device[key] = weakref.ref(
                        t, lambda _, k=key: self._device.pop(k, None))
        return out


@contextlib.contextmanager
def no_implicit_transfers(always=False):
    """Disallow implicit host syncs inside the block.

    Active when ``always=True`` (regression tests for specific fixes, the
    chip script's sync-free regions) or when ``REPRO_SANITIZE=1``
    (suite-wide hostile mode); a no-op otherwise. With CUDA initialised it
    arms ``torch.cuda.set_sync_debug_mode("error")`` and restores the
    previous mode on exit, also on an exception; otherwise it arms the
    host-read guard.
    """
    if not (always or enabled()):
        yield
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    else:
        with _HostReadGuard():
            yield


# ---------------------------------------------------------------------------
# global checks
# ---------------------------------------------------------------------------

_NO_DATA = ("empty", "new_empty", "empty_like", "empty_strided",
            "new_empty_strided")


class _NanCheck(TorchDispatchMode):
    """Raise at the first op whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] in _NO_DATA:
            return out  # uninitialised memory, not a result
        for t in _tensors(out):
            if t.is_floating_point() and t.device.type != "meta" \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError("NaN in the output of %s" % func)
        return out


_NAN_MODE = None


def install_global_checks():
    """Arm anomaly detection and the NaN check for the whole process."""
    global _NAN_MODE
    torch.autograd.set_detect_anomaly(True)
    if _NAN_MODE is None:
        _NAN_MODE = _NanCheck()
        _NAN_MODE.__enter__()


def uninstall_global_checks():
    """Undo :func:`install_global_checks` (tests that arm it locally)."""
    global _NAN_MODE
    torch.autograd.set_detect_anomaly(False)
    if _NAN_MODE is not None:
        _NAN_MODE.__exit__(None, None, None)
        _NAN_MODE = None


def install_if_enabled():
    """Conftest hook: activate everything iff REPRO_SANITIZE=1."""
    if not enabled():
        return False
    install_global_checks()
    ledger()
    return True
