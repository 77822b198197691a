"""The RA001–RA006 rule implementations, retargeted to eager PyTorch.

Each rule is deliberately repo-shaped rather than fully general: the goal
is catching the hazard classes an eager PyTorch port on one card can hit
(a host sync hidden in a device path, a branch frozen into a CUDA graph,
a host buffer reused before its non-blocking copy ran, a stream or graph
built per tick, a C prototype drifting from its ctypes signature) with
near-zero false positives on the idioms the port relies on (kw-only
static config, ``.shape`` peeks, event-guarded host halves, build-once
``if self._x is None`` members). Anything the analysis cannot resolve
statically it skips silently — an unresolvable form is not a finding.
RA006 lives in :mod:`repro_torch.analysis.cabi`.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.reachability import (
    FunctionInfo,
    ModuleIndex,
    Program,
    _dotted,
)

# tensor metadata: host values, no device read
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                 "requires_grad", "is_leaf", "is_meta", "is_sparse",
                 "itemsize", "nbytes", "names"}
_HOST_METHODS = {"size", "numel", "dim", "ndimension", "nelement",
                 "element_size", "stride", "storage_offset", "data_ptr",
                 "is_contiguous", "is_floating_point", "is_complex",
                 "is_signed", "is_pinned", "get_device", "untyped_storage",
                 "item", "tolist", "numpy", "cpu"}
# torch.X that are not tensor ops: host values, classes and scopes
_TORCH_HOST = {"device", "dtype", "finfo", "iinfo", "is_tensor", "numel",
               "is_floating_point", "is_complex", "get_default_dtype",
               "set_default_dtype", "manual_seed", "seed", "initial_seed",
               "is_grad_enabled", "set_grad_enabled", "no_grad",
               "enable_grad", "inference_mode", "autocast",
               "use_deterministic_algorithms",
               "are_deterministic_algorithms_enabled", "set_num_threads",
               "get_num_threads", "promote_types", "result_type", "can_cast",
               "compile", "load", "save", "typename", "broadcast_shapes",
               "get_float32_matmul_precision",
               "set_float32_matmul_precision", "get_rng_state",
               "set_rng_state"}
_TORCH_TENSOR_NS = ("torch.nn.functional.", "torch.linalg.", "torch.fft.",
                    "torch.special.", "torch.ops.", "torch.nn.init.")
_NEUTRAL_CALLS = {"len", "isinstance", "type", "id", "hash", "repr", "str",
                  "range", "print"}
_SYNC_BUILTINS = {"int", "float", "complex"}
_TO_HOST = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}
_SYNC_METHODS = {"item", "tolist", "numpy"}
# ops whose output shape depends on the data: the host waits for the count
_DATA_SHAPE = {"nonzero", "argwhere", "masked_select", "unique",
               "unique_consecutive"}
_IMPURE_PREFIXES = ("numpy.random.", "time.", "random.")
_IMPURE_BUILTINS = {"open", "input", "print"}
# torch's global RNG: draws that take ``generator=`` and forgot it ...
_RNG_DRAWS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
              "torch.normal", "torch.bernoulli", "torch.multinomial"}
_RNG_INPLACE = {"normal_", "uniform_", "bernoulli_", "random_",
                "exponential_"}
# ... draws that cannot take one, and reseeding the global state
_RNG_GLOBAL = {"torch.rand_like", "torch.randn_like", "torch.randint_like",
               "torch.manual_seed", "torch.random.manual_seed",
               "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
_STREAM_CTORS = {"torch.cuda.Stream", "torch.cuda.current_stream",
                 "torch.cuda.default_stream"}

# Host-side serving hot paths: per-tick dispatch/collect loops where an
# implicit sync stalls the pipeline (RA003) and a stream, graph or pinned
# buffer built per call costs every tick (RA005).
_HOT_FILES = ("launch/serve.py", "launch/cascade.py")
_HOT_FNS = {"dispatch", "collect", "_finish", "flush", "submit", "_launch", "pump"}


def _is_hot(info: FunctionInfo) -> bool:
    if not any(info.path.replace("\\", "/").endswith(f) for f in _HOT_FILES):
        return False
    return info.qualname.rsplit(".", 1)[-1] in _HOT_FNS


def _target_names(target):
    out = []
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            out.append(n.id)
    return out


def _kw(call, name):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_cpu(node) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _static_compare(test) -> bool:
    """Comparisons that are host dispatch, not control flow on a tensor:
    ``x is None`` / ``x is not None`` and ``mode == "pseudo"``-style
    string comparisons."""
    if not isinstance(test, ast.Compare):
        return False
    if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops) and any(
        isinstance(c, ast.Constant) and c.value is None
        for c in list(test.comparators) + [test.left]
    ):
        return True
    return all(
        isinstance(c, ast.Constant) and isinstance(c.value, str)
        for c in test.comparators
    )


def _narrowed(s: ast.If, idx: ModuleIndex):
    """``x`` after ``if isinstance(x, torch.Tensor): ... return``: the rest
    of the body sees ``x`` only when it is not a tensor."""
    t = s.test
    if not (isinstance(t, ast.Call) and _dotted(t.func) == "isinstance"
            and len(t.args) == 2 and isinstance(t.args[0], ast.Name)):
        return None
    if not any(isinstance(n, ast.Attribute) and n.attr == "Tensor"
               or isinstance(n, ast.Name) and n.id == "Tensor"
               for n in ast.walk(t.args[1])):
        return None
    if s.body and isinstance(s.body[-1], (ast.Return, ast.Raise)):
        return t.args[0].id
    return None


def _is_none_guard(test, negated=False) -> bool:
    """``x is None`` (or, ``negated``, ``x is not None``)."""
    op = ast.IsNot if negated else ast.Is
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], op)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None)


def rng_finding(idx: ModuleIndex, node: ast.Call):
    """The message of a draw from a global RNG, or None."""
    name = _dotted(node.func)
    expanded = idx.expand(name) if name else None
    if expanded and expanded.startswith("numpy.random."):
        return ("%s(): host RNG outside an explicit torch.Generator breaks "
                "replay determinism" % name)
    if expanded in _RNG_GLOBAL:
        return "%s() uses or reseeds torch's global RNG" % name
    gen = _kw(node, "generator")
    if expanded in _RNG_DRAWS and gen is None:
        return "%s() without generator= draws from torch's global RNG" % name
    if isinstance(node.func, ast.Attribute) and node.func.attr in _RNG_INPLACE \
            and gen is None:
        return ("%s() without generator= draws from torch's global RNG"
                % (name or node.func.attr))
    return None


# ---------------------------------------------------------------------------
# tensor taint
# ---------------------------------------------------------------------------


class _Taint:
    """Which expressions of one function are tensors (see the
    :mod:`~repro_torch.analysis.reachability` docstring for the rules)."""

    def __init__(self, program: Program, idx: ModuleIndex, info: FunctionInfo,
                 tainted):
        self.program = program
        self.idx = idx
        self.info = info
        self.tainted = set(tainted)
        self.streams = set()  # names bound to a CUDA stream

    def _torch_tensor_fn(self, expanded: str) -> bool:
        if expanded is None or not expanded.startswith("torch."):
            return False
        if expanded.startswith(_TORCH_TENSOR_NS):
            return True
        sub = expanded[len("torch."):]
        return "." not in sub and sub[:1].islower() and sub not in _TORCH_HOST

    def taints(self, e) -> bool:
        if e is None or isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_ATTRS:
                return False
            return self.taints(e.value)
        if isinstance(e, ast.Subscript):
            return self.taints(e.value)
        if isinstance(e, ast.Call):
            return self._call_taints(e)
        if isinstance(e, (ast.Lambda, ast.Dict, ast.DictComp, ast.JoinedStr)):
            return False
        if isinstance(e, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self.taints(e.elt) or any(self.taints(g.iter) for g in e.generators)
        return any(self.taints(c) for c in ast.iter_child_nodes(e))

    def _call_taints(self, e: ast.Call) -> bool:
        if isinstance(e.func, ast.Attribute):
            m = e.func.attr
            recv = e.func.value
            if m in _HOST_METHODS:
                return False
            if m == "to" and (any(_is_cpu(a) for a in e.args)
                              or _is_cpu(_kw(e, "device"))):
                return False
            if self.taints(recv):
                return True
        name = _dotted(e.func)
        if name is None:
            return False
        if name in _SYNC_BUILTINS or name in _NEUTRAL_CALLS or name == "bool":
            return False
        if self._torch_tensor_fn(self.idx.expand(name)):
            return True
        return self.program.returns_tensor(self.idx.module, self.info.qualname, name)

    def bind(self, targets, value):
        t = value is not None and self.taints(value)
        is_stream = (isinstance(value, ast.Call) and _dotted(value.func)
                     and self.idx.expand(_dotted(value.func)) in _STREAM_CTORS)
        for tg in targets:
            for name in _target_names(tg):
                (self.tainted.add if t else self.tainted.discard)(name)
                (self.streams.add if is_stream else self.streams.discard)(name)

    def is_stream(self, e) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.streams
        if isinstance(e, ast.Call):
            name = _dotted(e.func)
            return bool(name) and self.idx.expand(name) in _STREAM_CTORS
        return False

    def sync_message(self, node: ast.Call, bool_too: bool):
        """Why ``node`` is an implicit host sync, or None."""
        name = _dotted(node.func)
        expanded = self.idx.expand(name) if name else None
        if expanded == "torch.cuda.synchronize":
            return "torch.cuda.synchronize() waits for the whole device"
        if isinstance(node.func, ast.Attribute):
            m, recv = node.func.attr, node.func.value
            if m == "synchronize" and self.is_stream(recv):
                return "Stream.synchronize() waits for the whole stream"
            if m in _SYNC_METHODS and self.taints(recv):
                return ".%s() on a tensor copies it to the host and waits" % m
            if m in _DATA_SHAPE and self.taints(recv):
                return (".%s() sizes its output by the data: the host waits "
                        "for the count" % m)
        if name is None:
            return None
        arg_tainted = any(self.taints(a) for a in node.args)
        if (name in _SYNC_BUILTINS or (bool_too and name == "bool")) \
                and arg_tainted:
            return "%s() on a tensor reads it on the host" % name
        if expanded in _TO_HOST and arg_tainted:
            return "%s() on a tensor copies it to the host and waits" % name
        if expanded is not None and expanded.startswith("torch."):
            last = expanded.rsplit(".", 1)[-1]
            one_arg_where = (last == "where" and len(node.args) == 1
                             and not node.keywords)
            if (last in _DATA_SHAPE or one_arg_where) and arg_tainted:
                return ("%s() sizes its output by the data: the host waits "
                        "for the count" % name)
        return None


# ---------------------------------------------------------------------------
# RA001 / RA002 / RA003 inside capture- and sync-free-reachable functions
# ---------------------------------------------------------------------------


class _ReachableWalker:
    def __init__(self, engine, idx: ModuleIndex, info: FunctionInfo):
        self.engine = engine
        self.idx = idx
        self.info = info
        self.capture = engine.program.in_capture(info)
        self.where = ("capture-reachable code" if self.capture
                      else "sync-free-reachable code")
        self.t = _Taint(engine.program, idx, info, info.tensor_params)

    def _emit(self, rule, node, msg):
        self.engine.emit(rule, self.idx.path, node.lineno, "%s in %s" % (msg, self.where))

    def scan_expr(self, e):
        if e is None:
            return
        for node in ast.walk(e):
            if isinstance(node, ast.IfExp):
                self._flag_test(node.test, "conditional expression")
            elif isinstance(node, ast.BoolOp):
                for v in node.values:
                    if not _static_compare(v) and self.t.taints(v):
                        self._emit("RA001", node, "`and`/`or` calls bool() on a tensor")
                        break
            elif isinstance(node, ast.Call):
                self._scan_call(node)

    def _scan_call(self, node: ast.Call):
        name = _dotted(node.func)
        if name == "bool" and any(self.t.taints(a) for a in node.args):
            self._emit("RA001", node, "bool() on a tensor")
        msg = self.t.sync_message(node, bool_too=False)
        if msg:
            self._emit("RA003", node, msg)
        if not self.capture:
            return
        expanded = self.idx.expand(name) if name else ""
        if expanded.startswith(_IMPURE_PREFIXES) or name in _IMPURE_BUILTINS:
            self._emit("RA002", node, "impure call %s() runs once at capture, "
                       "not per replay" % name)
        elif rng_finding(self.idx, node):
            self._emit("RA002", node, "a global-RNG draw is frozen into the graph")

    def _flag_test(self, test, what):
        while isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                self._flag_test(v, what)
            return
        if _static_compare(test):
            return
        if self.t.taints(test):
            self._emit("RA001", test, "Python %s on a tensor (a host sync; "
                       "frozen under capture)" % what)

    def walk(self, stmts):
        for s in stmts:
            self._stmt(s)

    def _stmt(self, s):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # walked on their own when reachable
        if isinstance(s, (ast.If, ast.While)):
            self._flag_test(s.test, "if" if isinstance(s, ast.If) else "while")
            self.scan_expr(s.test)
            self.walk(s.body)
            self.walk(s.orelse)
            if isinstance(s, ast.If):
                self.t.tainted.discard(_narrowed(s, self.idx))
        elif isinstance(s, ast.Assert):
            self._flag_test(s.test, "assert")
            self.scan_expr(s.test)
        elif isinstance(s, ast.For):
            if self.t.taints(s.iter):
                self._emit("RA001", s, "for loop iterates a tensor")
            self.scan_expr(s.iter)
            self.t.bind([s.target], s.iter)
            self.walk(s.body)
            self.walk(s.orelse)
        elif isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self.scan_expr(s.value)
            if isinstance(s, ast.AugAssign):
                if self.t.taints(s.value):
                    self.t.tainted.update(_target_names(s.target))
            else:
                self.t.bind(s.targets if isinstance(s, ast.Assign) else [s.target],
                            s.value)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self.scan_expr(item.context_expr)
            self.walk(s.body)
        elif isinstance(s, ast.Try):
            self.walk(s.body)
            for h in s.handlers:
                self.walk(h.body)
            self.walk(s.orelse)
            self.walk(s.finalbody)
        else:
            for e in ast.iter_child_nodes(s):
                if isinstance(e, ast.expr):
                    self.scan_expr(e)


# ---------------------------------------------------------------------------
# RA003 on host-side serving hot paths
# ---------------------------------------------------------------------------


class _HotPathWalker:
    """Linear tensor tracking through dispatch/collect bodies.

    Explicit syncs are allowed: ``Event.synchronize()``/``Event.wait()``
    on a recorded event, ``.cpu()`` and ``.to("cpu")``. The rule flags
    only the implicit spellings (:meth:`_Taint.sync_message`) and Python
    branches on a tensor.
    """

    def __init__(self, engine, idx: ModuleIndex, info: FunctionInfo):
        self.engine = engine
        self.idx = idx
        self.info = info
        self.t = _Taint(engine.program, idx, info, info.tensor_params)

    def _emit(self, node, msg):
        self.engine.emit("RA003", self.idx.path, node.lineno,
                         "%s in hot serving path '%s'" % (msg, self.info.qualname))

    def _scan_expr(self, e):
        if e is None:
            return
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                msg = self.t.sync_message(node, bool_too=True)
                if msg:
                    self._emit(node, msg)

    def _test(self, test):
        self._scan_expr(test)
        if not _static_compare(test) and not isinstance(test, ast.BoolOp) \
                and self.t.taints(test):
            self._emit(test, "a Python branch on a tensor reads it on the host")

    def walk(self, stmts):
        for s in stmts:
            self._stmt(s)

    def _stmt(self, s):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(s, ast.For):
            self._scan_expr(s.iter)
            self.t.bind([s.target], s.iter)
            self.walk(s.body)
            self.walk(s.orelse)
            return
        if isinstance(s, (ast.If, ast.While)):
            self._test(s.test)
            self.walk(s.body)
            self.walk(s.orelse)
            if isinstance(s, ast.If):
                self.t.tainted.discard(_narrowed(s, self.idx))
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._scan_expr(item.context_expr)
            self.walk(s.body)
            return
        if isinstance(s, ast.Try):
            self.walk(s.body)
            for h in s.handlers:
                self.walk(h.body)
            self.walk(s.orelse)
            self.walk(s.finalbody)
            return
        for e in ast.iter_child_nodes(s):
            if isinstance(e, ast.expr):
                self._scan_expr(e)
        if isinstance(s, (ast.Assign, ast.AnnAssign)) and s.value is not None:
            self.t.bind(s.targets if isinstance(s, ast.Assign) else [s.target], s.value)


# ---------------------------------------------------------------------------
# RA004: use before an asynchronous hand-off completed
# ---------------------------------------------------------------------------


def _base_token(e):
    """``buf``, ``buf[k]``, ``buf[k][0]``, ``self._x[k]`` -> its buffer's
    dotted name."""
    while isinstance(e, ast.Subscript):
        e = e.value
    return _dotted(e)


def _starts_hand_off(call: ast.Call) -> bool:
    """A ``non_blocking=True`` copy or an ``async_op=True`` collective."""
    return any(k.arg in ("non_blocking", "async_op") and isinstance(k.value, ast.Constant)
               and k.value.value is True for k in call.keywords)


class _HandOffWalker:
    """Linear scan of one function for buffers in flight.

    * ``src.to(dev, non_blocking=True)`` / ``src.cuda(non_blocking=True)``
      / ``dst.copy_(src, non_blocking=True)``: ``src`` may still be read
      by the copy engine, so an in-place write of it is a hazard;
    * ``dst = x.to("cpu", non_blocking=True)`` / ``x.cpu(non_blocking=
      True)`` / ``dst.copy_(x, non_blocking=True)``: ``dst`` is not
      filled yet, so a read of it is a hazard;
    * ``w = dist.<op>(t, ..., async_op=True)``: ``t`` may be neither read
      nor written before ``w.wait()``.

    Any ``.synchronize()`` or ``.wait()`` completes them all. Handing a
    buffer on (into a record's constructor, a ``return``, a rebind) is
    not a read; a rebind of the name ends its tracking.
    """

    def __init__(self, engine, idx: ModuleIndex, info: FunctionInfo):
        self.engine = engine
        self.idx = idx
        self.info = info
        self.sources = {}  # token -> line of the copy that reads it
        self.dests = {}  # token -> line of the copy that fills it
        self.collective = {}  # token -> line of the async collective

    def _emit(self, node, msg):
        self.engine.emit("RA004", self.idx.path, node.lineno, msg)

    def walk(self, stmts):
        for s in stmts:
            self._stmt(s)

    def _stmt(self, s):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(s, (ast.If, ast.For, ast.While)):
            head = s.test if not isinstance(s, ast.For) else s.iter
            self._expr_stmt(head)
            self.walk(s.body)
            self.walk(s.orelse)
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._expr_stmt(item.context_expr)
            self.walk(s.body)
            return
        if isinstance(s, ast.Try):
            self.walk(s.body)
            for h in s.handlers:
                self.walk(h.body)
            self.walk(s.orelse)
            self.walk(s.finalbody)
            return
        if isinstance(s, ast.Return):
            v = s.value
            parts = v.elts if isinstance(v, ast.Tuple) else [v]
            if not all(isinstance(p, (ast.Name, ast.Attribute)) or p is None
                       for p in parts):
                self._expr_stmt(v)  # handing a buffer to the caller is no read
            return
        if isinstance(s, ast.AugAssign):
            self._write(_base_token(s.target), s)
            self._expr_stmt(s.value)
            return
        if not isinstance(s, (ast.Assign, ast.AnnAssign)):
            for e in ast.iter_child_nodes(s):
                if isinstance(e, ast.expr):
                    self._expr_stmt(e)
            return
        value = s.value
        targets = s.targets if isinstance(s, ast.Assign) else [s.target]
        # an alias is a hand-on, not a read
        calls = [n for n in ast.walk(value) if isinstance(n, ast.Call)] \
            if value is not None else []
        if not isinstance(value, (ast.Name, ast.Attribute, ast.Subscript)):
            self._expr_stmt(value, start=False)
        self._start_sources(value, calls)
        for tg in targets:
            if isinstance(tg, ast.Subscript):
                self._write(_base_token(tg), s)
                continue
            for t in ast.walk(tg):
                tok = _dotted(t)
                if tok:
                    for d in (self.sources, self.dests, self.collective):
                        d.pop(tok, None)
        self._start_dests(value, targets, calls)

    # -- reads, writes, completions --------------------------------------
    def _write(self, tok, node):
        if tok in self.sources:
            self._emit(node, "'%s' written in place while the non-blocking copy "
                       "of line %d may still read it" % (tok, self.sources.pop(tok)))
        if tok in self.collective:
            self._emit(node, "'%s' written before the wait() of the async "
                       "collective of line %d" % (tok, self.collective.pop(tok)))

    def _read(self, tok, node):
        if tok in self.dests:
            self._emit(node, "'%s' read before the non-blocking copy of line %d "
                       "that fills it completed" % (tok, self.dests.pop(tok)[0]))
        if tok in self.collective:
            self._emit(node, "'%s' read before the wait() of the async "
                       "collective of line %d" % (tok, self.collective.pop(tok)))

    def _expr_stmt(self, e, start=True):
        if e is None:
            return
        calls = [n for n in ast.walk(e) if isinstance(n, ast.Call)]
        if any(isinstance(c.func, ast.Attribute)
               and c.func.attr in ("synchronize", "wait") for c in calls):
            self.sources.clear()
            self.dests.clear()
            self.collective.clear()
            return
        handed = set()  # nodes passed whole to a constructor
        host_reads = set()  # nodes read on the host (see _Taint.sync_message)
        for c in calls:
            name = _dotted(c.func) or ""
            if name.rsplit(".", 1)[-1].lstrip("_")[:1].isupper():
                handed.update(id(a) for a in c.args)
                handed.update(id(k.value) for k in c.keywords)
            if name in _SYNC_BUILTINS | {"bool", "list", "iter"} \
                    or self.idx.expand(name) in _TO_HOST:
                host_reads.update(id(a) for a in c.args)
            if isinstance(c.func, ast.Attribute):
                m = c.func.attr
                tok = _base_token(c.func.value)
                if m in _SYNC_METHODS:
                    host_reads.add(id(c.func.value))
                if m == "record_stream":
                    handed.add(id(c.func.value))
                elif m.endswith("_") and not m.startswith("_") and tok:
                    self._write(tok, c)
                    handed.add(id(c.func.value))
        self._loads(e, handed, host_reads)
        if start:
            self._start_sources(e, calls)
            self._start_dests(e, [], calls)

    def _loads(self, e, handed, host_reads):
        stack = [e]
        while stack:
            n = stack.pop()
            if id(n) in handed:
                continue
            if isinstance(n, (ast.Name, ast.Attribute, ast.Subscript)):
                tok = _base_token(n)
                # a device destination is read in stream order; only a read
                # on the host can see it unfilled
                if tok in self.collective or (tok in self.dests and (
                        self.dests[tok][1] or id(n) in host_reads)):
                    self._read(tok, n)
                    continue
            stack.extend(ast.iter_child_nodes(n))

    @staticmethod
    def _nb_copies(calls):
        for c in calls:
            nb = _kw(c, "non_blocking")
            if isinstance(c.func, ast.Attribute) and isinstance(nb, ast.Constant) \
                    and nb.value is True:
                m = c.func.attr
                to_host = m == "cpu" or (m == "to" and (
                    any(_is_cpu(a) for a in c.args) or _is_cpu(_kw(c, "device"))))
                yield c, m, _base_token(c.func.value), to_host

    def _start_sources(self, e, calls):
        """Record the host sources and the collectives that ``e`` starts."""
        for c, m, recv, to_host in self._nb_copies(calls):
            if m == "copy_" and c.args:
                src = _base_token(c.args[0])
                if src:
                    self.sources[src] = c.lineno
            elif m in ("to", "cuda") and not to_host and recv:
                self.sources[recv] = c.lineno
        for c in calls:
            asy = _kw(c, "async_op")
            name = _dotted(c.func) or ""
            if isinstance(asy, ast.Constant) and asy.value is True \
                    and self.idx.expand(name).startswith("torch.distributed."):
                for a in list(c.args) + [k.value for k in c.keywords
                                         if k.arg not in ("group", "async_op", "op")]:
                    tok = _base_token(a)
                    if tok:
                        self.collective[tok] = c.lineno

    def _start_dests(self, e, targets, calls):
        """Record the destinations that ``e`` starts filling: a host one
        (``.to("cpu")``, ``.cpu()``) is unsafe to read at all, a
        ``copy_`` one (host or device) to read on the host."""
        for c, m, recv, to_host in self._nb_copies(calls):
            if m == "copy_" and recv:
                self.dests[recv] = (c.lineno, False)
            elif to_host:
                for tg in targets:
                    tok = _dotted(tg)
                    if tok:
                        self.dests[tok] = (c.lineno, True)


# ---------------------------------------------------------------------------
# RA005: rebuild hazards
# ---------------------------------------------------------------------------


def _build_message(idx: ModuleIndex, node: ast.Call):
    """What ``node`` builds, if it is one of the costly constructions."""
    name = _dotted(node.func)
    expanded = idx.expand(name) if name else ""
    if expanded in ("torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph"):
        return "a CUDA graph"
    if expanded == "torch.cuda.Stream":
        return "a CUDA stream"
    if expanded == "torch.Generator":
        return "a torch.Generator"
    if expanded == "torch.compile":
        return "a torch.compile wrapper"
    if expanded.endswith(("_build.build", "_build.load")):
        return "a kernel library (%s)" % name
    if isinstance(node.func, ast.Attribute) and node.func.attr == "pin_memory":
        return "a pinned host buffer (pin_memory())"
    pin = _kw(node, "pin_memory")
    if pin is not None and not (isinstance(pin, ast.Constant) and pin.value is False):
        return "a pinned host buffer (pin_memory=)"
    return None


def hot_closure(program: Program, idx: ModuleIndex):
    """The hot serving functions of ``idx`` and the functions of the same
    module they call (through ``self.`` or a bare name), transitively."""
    work = [f.key for f in idx.functions.values() if _is_hot(f)]
    seen = set()
    while work:
        key = work.pop()
        if key in seen:
            continue
        seen.add(key)
        f = program.functions[key]
        for callee in f.calls:
            if "." in callee and not callee.startswith("self."):
                continue
            nxt = program.resolve_function(f.module, f.qualname, callee)
            if nxt and nxt.startswith(idx.module + ":"):
                work.append(nxt)
    return seen


class _RebuildWalker:
    def __init__(self, engine, idx: ModuleIndex, info: FunctionInfo, hot: bool):
        self.engine = engine
        self.idx = idx
        self.info = info
        self.hot = hot

    def run(self):
        self._walk(self.info.node.body, in_loop=False, once=False)

    def _walk(self, stmts, in_loop, once):
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(s, (ast.For, ast.While)):
                for e in ast.iter_child_nodes(s):
                    if isinstance(e, ast.expr):
                        self._exprs(e, in_loop, once)
                self._walk(s.body, True, once)
                self._walk(s.orelse, in_loop, once)
                continue
            if isinstance(s, ast.If):
                self._exprs(s.test, in_loop, once)
                guard = _is_none_guard(s.test)
                self._walk(s.body, in_loop, once or guard)
                self._walk(s.orelse, in_loop, once)
                # `if self._x is not None: return` guards the rest of the body
                if _is_none_guard(s.test, negated=True) and s.body \
                        and isinstance(s.body[-1], ast.Return):
                    once = True
                continue
            for e in ast.iter_child_nodes(s):
                if isinstance(e, ast.expr):
                    self._exprs(e, in_loop, once)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                    self._walk(sub, in_loop, once)
            for h in getattr(s, "handlers", []):
                self._walk(h.body, in_loop, once)

    def _exprs(self, e, in_loop, once):
        for node in ast.walk(e):
            if not isinstance(node, ast.Call):
                continue
            what = _build_message(self.idx, node)
            if what is None:
                continue
            if in_loop:
                self.engine.emit(
                    "RA005", self.idx.path, node.lineno,
                    "%s built inside a loop: one per iteration" % what)
            elif self.hot and not once:
                self.engine.emit(
                    "RA005", self.idx.path, node.lineno,
                    "%s built on every call of hot serving path '%s': build it "
                    "once (`if self._x is None: self._x = ...`)"
                    % (what, self.info.qualname))


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class RuleEngine:
    def __init__(self, program: Program):
        self.program = program
        self.findings = []
        self._seen = set()

    def emit(self, rule, path, line, msg):
        key = (rule, path, line)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(rule, path, line, msg))

    def check_module(self, idx: ModuleIndex):
        hot = hot_closure(self.program, idx)
        for info in list(idx.functions.values()):
            if self.program.is_reachable(info):
                _ReachableWalker(self, idx, info).walk(info.body)
            if isinstance(info.node, (ast.With, ast.Lambda)):
                continue  # a capture body or a lambda: walked as a root only
            if _is_hot(info) and not self.program.is_reachable(info):
                _HotPathWalker(self, idx, info).walk(info.node.body)
            if any(_starts_hand_off(c) for _, c in info.callsites):
                _HandOffWalker(self, idx, info).walk(info.node.body)
            if any(_build_message(idx, c) for _, c in info.callsites):
                _RebuildWalker(self, idx, info, info.key in hot).run()
        # RA002 anywhere: the port draws only from explicit generators
        for n in ast.walk(idx.tree):
            if isinstance(n, ast.Call):
                msg = rng_finding(idx, n)
                if msg:
                    self.emit("RA002", idx.path, n.lineno, msg)
        return self.findings
