"""Whole-program reachability over the port's ``src/repro_torch`` tree.

The rules in :mod:`repro_torch.analysis.rules` need three global facts no
single-file pass can supply:

* which functions run *under a CUDA graph capture* — the body of every
  ``with torch.cuda.graph(...)`` block and every callable handed to
  ``torch.cuda.make_graphed_callables``, plus everything they
  transitively call (the **capture** roots);
* which functions run on the card's **sync-free** paths — the device
  halves that ``chip_smoke.py`` drives under
  ``torch.cuda.set_sync_debug_mode("error")``, named in
  :data:`SYNC_FREE_ROOTS`, plus everything they transitively call;
* which names in a given function resolve to which function of the
  program (imports, aliases, ``functools.partial``, ``self.`` methods,
  nested defs).

Calls are resolved by name only. A method called on an object other than
``self`` (``model.decode_step(...)``) does not resolve, so an entry point
reached only that way is named as a root of its own.

Tensor taint comes from the code, not from a trace. A value is a tensor
if it is a parameter annotated ``torch.Tensor`` (or an optional or a
container of one), the result of a ``torch.*``/``F.*`` call, of a tensor
method on a tensor, or of a call to a function of the program whose
return annotation names ``Tensor``. A subscript or an attribute of a
tensor is a tensor, except its metadata (``.shape``, ``.dtype``,
``.device``, ``.ndim``, ``.size()``, ``.numel()``, ``.is_cuda``).
**Limit:** parameters without an annotation, and parameters annotated as
configs, ``str``, ``int`` or ``bool``, are static; a tensor that reaches
an unannotated parameter is not followed into the callee.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

#: the card's sync-free device paths: (file suffix, qualified name). Each
#: runs under ``torch.cuda.set_sync_debug_mode("error")`` in chip_smoke.py
SYNC_FREE_ROOTS = (
    ("sensing/stream.py", "chunk_device_half"),
    ("launch/steps.py", "build_decode_cell.serve_step"),
    ("models/lm.py", "Model.decode_step"),
    ("train/loop.py", "make_train_step.step"),
)

_GRAPH_CTX = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
_GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables",
                      "torch.cuda.graphs.make_graphed_callables"}


def _dotted(node: ast.AST):
    """Render a Name/Attribute chain as ``a.b.c``; None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def names_tensor(annotation) -> bool:
    """Whether an annotation names ``Tensor`` anywhere (``torch.Tensor``,
    ``Tensor | None``, ``tuple[torch.Tensor, Any]``, a string form)."""
    if annotation is None:
        return False
    for n in ast.walk(annotation):
        if isinstance(n, ast.Name) and n.id == "Tensor":
            return True
        if isinstance(n, ast.Attribute) and n.attr == "Tensor":
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "Tensor" in n.value:
            return True
    return False


def _calls_in(nodes):
    out = []
    for root in nodes:
        for n in ast.walk(root):
            if isinstance(n, ast.Call):
                name = _dotted(n.func)
                if name:
                    out.append((name, n))
    return tuple(out)


@dataclass
class FunctionInfo:
    module: str
    qualname: str
    path: str
    node: ast.AST  # FunctionDef / AsyncFunctionDef / Lambda / With (capture)
    params: tuple = ()
    kwonly: tuple = ()
    calls: tuple = ()  # dotted callee strings, in source order
    callsites: tuple = ()  # (dotted callee, ast.Call) pairs
    tensor_params: frozenset = frozenset()  # params annotated as tensors
    returns_tensor: bool = False

    @property
    def key(self) -> str:
        return "%s:%s" % (self.module, self.qualname)

    @property
    def body(self):
        """The statements to walk (a lambda's body is one expression)."""
        if isinstance(self.node, ast.Lambda):
            return [ast.Expr(self.node.body, lineno=self.node.lineno,
                             col_offset=self.node.col_offset)]
        return self.node.body


@dataclass
class ModuleIndex:
    module: str
    path: str
    tree: ast.Module
    text: str
    imports: dict = field(default_factory=dict)  # alias -> dotted
    functions: dict = field(default_factory=dict)  # qualname -> FunctionInfo
    root_names: list = field(default_factory=list)  # [(kind, name)]

    def expand(self, dotted: str) -> str:
        head, _, rest = dotted.partition(".")
        base = self.imports.get(head, head)
        return base + ("." + rest if rest else "")


def module_name_for(path: str) -> str:
    parts = path.replace("\\", "/").rstrip("/").split("/")
    stem = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    parts = parts[:-1] + [stem]
    for pkg in ("repro_torch", "repro"):
        if pkg in parts:
            parts = parts[parts.index(pkg):]
            break
    else:
        parts = [stem]
    if parts[-1] == "__init__":
        parts = parts[:-1] or [stem]
    return ".".join(parts)


def unwrap_partial(node: ast.AST, idx: ModuleIndex) -> ast.AST:
    """``functools.partial(f, ...)`` -> ``f`` (recursively)."""
    while isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name is None:
            break
        if idx.expand(name).rsplit(".", 1)[-1] != "partial":
            break
        if not node.args:
            break
        node = node.args[0]
    return node


def _function_info(idx, qual, node) -> FunctionInfo:
    args = node.args
    params = tuple(a.arg for a in args.posonlyargs + args.args)
    kwonly = tuple(a.arg for a in args.kwonlyargs)
    tensor = frozenset(
        a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
        if names_tensor(a.annotation))
    callsites = _calls_in([node])
    return FunctionInfo(
        idx.module, qual, idx.path, node, params, kwonly,
        tuple(name for name, _ in callsites), callsites, tensor,
        names_tensor(getattr(node, "returns", None)))


class _ModuleVisitor(ast.NodeVisitor):
    def __init__(self, idx: ModuleIndex):
        self.idx = idx
        self.scope = []  # class/function name stack

    # -- imports ---------------------------------------------------------
    def visit_Import(self, node):
        for a in node.names:
            self.idx.imports[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0]
            )

    def visit_ImportFrom(self, node):
        base = node.module or ""
        for a in node.names:
            self.idx.imports[a.asname or a.name] = (base + "." if base else "") + a.name

    # -- scope tracking --------------------------------------------------
    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_FunctionDef(self, node):
        qual = ".".join(self.scope + [node.name])
        self.idx.functions[qual] = _function_info(self.idx, qual, node)
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- capture roots ---------------------------------------------------
    def _expanded(self, node):
        name = _dotted(node)
        return self.idx.expand(name) if name else None

    def visit_With(self, node):
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call) and self._expanded(ctx.func) in _GRAPH_CTX:
                qual = ".".join(self.scope + ["capture@%d" % node.lineno])
                callsites = _calls_in(node.body)
                self.idx.functions[qual] = FunctionInfo(
                    self.idx.module, qual, self.idx.path, node,
                    calls=tuple(n for n, _ in callsites), callsites=callsites)
                self.idx.root_names.append(("capture", qual))
        self.generic_visit(node)

    def visit_Call(self, node):
        if self._expanded(node.func) in _GRAPHED_CALLABLES and node.args:
            first = node.args[0]
            elems = first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]
            for e in elems:
                src = unwrap_partial(e, self.idx)
                name = _dotted(src)
                if name:
                    self.idx.root_names.append(("capture", name))
                elif isinstance(src, ast.Lambda):
                    qual = ".".join(self.scope + ["lambda@%d" % src.lineno])
                    self.idx.functions[qual] = _function_info(self.idx, qual, src)
                    self.idx.root_names.append(("capture", qual))
        self.generic_visit(node)


def index_module(path: str, text: str, module: str = None) -> ModuleIndex:
    tree = ast.parse(text, filename=path)
    idx = ModuleIndex(module or module_name_for(path), path, tree, text)
    _ModuleVisitor(idx).visit(tree)
    norm = path.replace("\\", "/")
    for suffix, qual in SYNC_FREE_ROOTS:
        if norm.endswith(suffix) and qual in idx.functions:
            idx.root_names.append(("sync-free", qual))
    return idx


class Program:
    """Cross-module index + capture and sync-free reachability."""

    def __init__(self, modules):
        self.modules = {m.module: m for m in modules}
        self.functions = {}  # "module:qual" -> FunctionInfo
        for m in modules:
            for f in m.functions.values():
                self.functions[f.key] = f
        self.capture = self._reach("capture")
        # a capture is sync-free too: a host sync inside one is an error
        self.sync_free = self._reach("sync-free") | self.capture

    # -- name resolution -------------------------------------------------
    def resolve_function(self, module: str, caller_qual: str, dotted: str):
        """Resolve a callee's dotted name (as written) to a function key."""
        idx = self.modules.get(module)
        if idx is None:
            return None
        if dotted.startswith("self."):
            cls = caller_qual.split(".")[0] if caller_qual else ""
            cand = "%s:%s.%s" % (module, cls, dotted[5:])
            if cand in self.functions:
                return cand
            return None
        if "." not in dotted:
            cand = "%s:%s" % (module, dotted)
            if cand in self.functions:
                return cand
            # nested defs called by bare name inside their enclosing function
            scope = caller_qual
            while scope:
                cand = "%s:%s.%s" % (module, scope, dotted)
                if cand in self.functions:
                    return cand
                scope = scope.rpartition(".")[0]
        expanded = idx.expand(dotted)
        for mod in self.modules:
            if expanded.startswith(mod + "."):
                qual = expanded[len(mod) + 1:]
                cand = "%s:%s" % (mod, qual)
                if cand in self.functions:
                    return cand
        return None

    def returns_tensor(self, module: str, caller_qual: str, dotted: str) -> bool:
        key = self.resolve_function(module, caller_qual, dotted)
        return key is not None and self.functions[key].returns_tensor

    # -- reachability ----------------------------------------------------
    def _reach(self, kind):
        work = []
        for m in self.modules.values():
            for k, name in m.root_names:
                if k != kind:
                    continue
                key = "%s:%s" % (m.module, name) if name in m.functions \
                    else self.resolve_function(m.module, "", name)
                if key:
                    work.append(key)
        seen = set()
        while work:
            key = work.pop()
            if key in seen or key not in self.functions:
                continue
            seen.add(key)
            f = self.functions[key]
            for callee in f.calls:
                nxt = self.resolve_function(f.module, f.qualname, callee)
                if nxt and nxt not in seen:
                    work.append(nxt)
        return seen

    def is_reachable(self, info: FunctionInfo) -> bool:
        return info.key in self.sync_free

    def in_capture(self, info: FunctionInfo) -> bool:
        return info.key in self.capture
