"""The port's own static analysis + runtime sanitizers (eager PyTorch on
one card).

The twin of ``repro.analysis``: the same module names, the same CLI, the
same waiver grammar and the same rule codes, retargeted from jit,
``shard_map`` and Pallas to what can go wrong in eager PyTorch on an
H100 — host syncs on the card's sync-free paths, CUDA graph captures,
non-blocking copies, per-tick rebuilds and the ``ctypes`` ABI of the
hand-written kernels:

========  ==============================================================
RA001     Python control flow (``if``/``while``/``assert``/``bool()``/
          ``for``) on a tensor in capture- or sync-free-reachable code:
          a host sync on the card, a branch frozen into a CUDA graph.
RA002     Impurity in capture-reachable code (``time``, I/O, ``print``,
          ``random``, ``np.random``, torch's global RNG) runs once at
          capture — plus, anywhere in ``src/repro_torch``, bare
          ``np.random`` and a torch draw without ``generator=`` (the port
          draws only from explicit generators).
RA003     Implicit host<->device sync (``.item()``, ``.tolist()``,
          ``.numpy()``, ``int/float/bool(t)``, ``np.asarray(t)``,
          ``torch.cuda.synchronize()``, ``Stream.synchronize()``, the
          data-shaped ``nonzero``/``masked_select``/``unique``/one-argument
          ``torch.where``) in sync-free-reachable code or the hot serving
          dispatch/collect paths of ``launch/serve.py`` and
          ``launch/cascade.py``. ``Event.synchronize()``, ``.cpu()`` and
          ``.to("cpu")`` are the explicit, allowed forms.
RA004     Use before an asynchronous hand-off completed: the host source
          of a ``non_blocking=True`` copy written in place, its host
          destination read, or a tensor of an ``async_op=True`` collective
          touched, before a ``synchronize()``/``wait()``.
RA005     Rebuild hazards: a ``CUDAGraph``, ``Stream``, ``Generator``,
          ``torch.compile``, pinned buffer or kernel library built inside a
          loop or on every call of a hot serving path (the build-once
          ``if self._x is None: self._x = ...`` form is the good one).
RA006     The C launch contract of ``kernels/csrc/*.cu`` against
          ``kernels/_build.py``'s ``SIGNATURES``: entry points, arity and
          parameter kinds, ``lib.<entry>(...)`` call arity, dynamic shared
          memory opt-ins, ``constexpr`` shared-memory sizes.
========  ==============================================================

Run it::

    PYTHONPATH=src python -m repro_torch.analysis --check src/repro_torch

Deliberate violations carry an inline waiver **with a reason**::

    np.asarray(frames)  # repro-lint: disable=RA003 (admission boundary)

(or on the line above; ``# repro-lint: disable-file=RA002 (reason)``
waives a whole file; in a C source the same grammar follows ``//``). A
waiver without a reason is itself an error. ``--json PATH`` writes
machine-readable findings; ``--check`` exits non-zero on any unwaived
finding.

The runtime half lives in :mod:`repro_torch.analysis.sanitize`.
"""

from repro_torch.analysis.findings import Finding, findings_json
from repro_torch.analysis.linter import lint_paths, lint_text

__all__ = ["Finding", "findings_json", "lint_paths", "lint_text"]
