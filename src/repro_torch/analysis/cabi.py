"""RA006: the C launch contract of ``kernels/csrc/*.cu`` against
``kernels/_build.py``.

The port binds its kernels with ``ctypes``: ``_build.SIGNATURES`` declares
each ``extern "C"`` entry point's return and argument types by hand, and
nothing at run time checks them — an extra ``int`` in a prototype, or an
``int`` that became a ``float``, is passed as garbage without complaint.
This checker reads ``SIGNATURES`` from ``_build.py``'s AST (it never
imports or builds anything) and holds it against the sources:

* every ``extern "C"`` entry of ``csrc/<name>.cu`` is in
  ``SIGNATURES[name]``, and every entry there is in the source;
* the arity and each parameter's kind match: pointers and
  ``cudaStream_t`` are ``c_void_p``, ``int`` is ``c_int``, ``float`` is
  ``c_float``, and a ``size_t`` return is ``c_size_t``;
* every ``lib.<entry>(...)`` call in ``kernels/*.py`` passes the declared
  count;
* every ``<<<grid, block, smem, stream>>>`` launch whose ``smem`` is not
  ``0`` and not a constant within the 48 KiB every kernel may take names a
  kernel with a ``cudaFuncSetAttribute(...,
  cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` in the same
  translation unit (the ``.cu`` and the local headers it includes);
* every ``constexpr`` shared-memory size it can evaluate (a name holding
  ``smem``, at namespace scope or in a ``template <int N> struct``
  instantiated by a ``using``) is at most :data:`SMEM_OPT_IN_MAX`.

Waivers in C sources use the same grammar behind ``//``.
"""

from __future__ import annotations

import ast
import os
import re

#: the H100's opt-in maximum of dynamic shared memory per block (bytes)
SMEM_OPT_IN_MAX = 232448
#: what a block may take without the opt-in (bytes)
SMEM_DEFAULT_MAX = 48 * 1024

_CTYPES_KIND = {"c_void_p": "ptr", "c_int": "int", "c_int32": "int",
                "c_float": "float", "c_double": "double", "c_size_t": "size_t",
                "c_int64": "int64", "c_longlong": "int64", "c_uint": "uint",
                "c_uint32": "uint", "c_bool": "bool"}
_C_KIND = {"int": "int", "int32_t": "int", "signed": "int", "float": "float",
           "double": "double", "size_t": "size_t", "int64_t": "int64",
           "long long": "int64", "unsigned": "uint", "unsigned int": "uint",
           "uint32_t": "uint", "bool": "bool", "void": "void"}
_SIZEOF = {"float": 4, "int": 4, "int32_t": 4, "uint32_t": 4, "unsigned": 4,
           "int8_t": 1, "uint8_t": 1, "char": 1, "int16_t": 2, "uint16_t": 2,
           "double": 8, "int64_t": 8, "size_t": 8, "half": 2, "__half": 2}


def strip_comments(text: str) -> str:
    """``text`` with C comments blanked (string literals kept whole, so a
    ``//`` inside one is no comment), newlines kept (so offsets map to the
    same lines)."""
    def blank(m):
        s = m.group(0)
        return s if s.startswith('"') else re.sub(r"[^\n]", " ", s)
    return re.sub(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"', blank, text,
                  flags=re.S)


def _line(text, pos):
    return text.count("\n", 0, pos) + 1


def _match_brace(text, open_pos):
    """Offset just past the ``}`` closing the ``{`` at ``open_pos``."""
    depth = 0
    for i in range(open_pos, len(text)):
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def _split_top(s):
    """Split at commas outside parentheses, brackets and braces."""
    out, depth, cur = [], 0, []
    for c in s:
        if c in "([{<":
            depth += 1
        elif c in ")]}>":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    out.append("".join(cur))
    return [x.strip() for x in out]


def _c_kind(decl: str):
    """The ctypes kind a C parameter (or return) declaration needs."""
    d = decl.strip()
    if "*" in d or "[" in d or "cudaStream_t" in d:
        return "ptr"
    words = [w for w in re.findall(r"\w+", d) if w not in ("const", "volatile")]
    for n in (2, 1):
        key = " ".join(words[:n])
        if key in _C_KIND:
            return _C_KIND[key]
    return "?" + " ".join(words[:-1] or words)


# ---------------------------------------------------------------------------
# the C side: extern "C" prototypes, launches, opt-ins, constexpr sizes
# ---------------------------------------------------------------------------


def extern_c_entries(text: str):
    """``{name: (return kind, [param kinds], line)}`` of every function
    defined or declared inside an ``extern "C" { ... }`` block."""
    clean = strip_comments(text)
    out = {}
    for m in re.finditer(r'extern\s+"C"\s*\{', clean):
        start = m.end()
        end = _match_brace(clean, m.end() - 1) - 1
        i, head_start = start, start
        while i < end:
            c = clean[i]
            if c in "{;":
                head = clean[head_start:i]
                fm = re.search(r"([\w\s\*]+?)\b(\w+)\s*\(([^()]*)\)\s*$", head, re.S)
                if fm:
                    params = fm.group(3).strip()
                    kinds = [] if params in ("", "void") else [
                        _c_kind(p) for p in _split_top(params)]
                    line = _line(clean, head_start + fm.start(2))
                    out[fm.group(2)] = (_c_kind(fm.group(1) + " x"), kinds, line)
                if c == "{":
                    i = _match_brace(clean, i)
                else:
                    i += 1
                head_start = i
                continue
            i += 1
    return out


def local_includes(text: str):
    return re.findall(r'#\s*include\s*"([^"]+)"', text)


class _ConstEnv:
    """``constexpr`` integers of one translation unit, evaluated."""

    def __init__(self, files):
        self.values = {}  # name -> value
        self.defs = []  # (path, line, display name, value)
        self.namespaces = set()
        for _, clean in files:
            self.namespaces.update(re.findall(r"namespace\s+(\w+)\s*\{", clean))
        for path, clean in files:
            self._scan(path, clean)

    def eval(self, expr, extra=None):
        e = expr
        for ns in self.namespaces | {"std"}:
            e = re.sub(r"\b%s::" % ns, "", e)
        if "::" in e or "?" in e:
            return None
        e = re.sub(r"sizeof\s*\(\s*(\w+)\s*\)",
                   lambda m: str(_SIZEOF.get(m.group(1), "None")), e)
        e = re.sub(r"\(\s*(?:unsigned\s+)?(?:int|size_t|long|int32_t|int64_t|"
                   r"uint32_t|unsigned)\s*\)", "", e)
        e = re.sub(r"\b(\d+)[uUlL]+\b", r"\1", e).replace("/", "//")
        try:
            tree = ast.parse(e.strip(), mode="eval")
        except SyntaxError:
            return None
        env = dict(self.values)
        env.update(extra or {})
        return _eval_int(tree.body, env)

    def _scan(self, path, clean):
        templates = []
        for m in re.finditer(r"template\s*<\s*int\s+(\w+)\s*>\s*struct\s+(\w+)\s*\{",
                             clean):
            end = _match_brace(clean, m.end() - 1)
            templates.append((m.group(2), m.group(1), m.end(), end))
        inside = [(a, b) for _, _, a, b in templates]
        for m in _CONSTEXPR.finditer(clean):
            if any(a <= m.start() < b for a, b in inside):
                continue
            v = self.eval(m.group(2))
            if v is not None:
                self.values[m.group(1)] = v
                self.defs.append((path, _line(clean, m.start(1)), m.group(1), v))
        for m in re.finditer(r"using\s+(\w+)\s*=\s*(\w+)\s*<\s*(\d+)\s*>\s*;", clean):
            for name, param, a, b in templates:
                if name != m.group(2):
                    continue
                local = {param: int(m.group(3))}
                for cm in _CONSTEXPR.finditer(clean, a, b):
                    v = self.eval(cm.group(2), local)
                    if v is None:
                        continue
                    local[cm.group(1)] = v
                    self.defs.append((path, _line(clean, cm.start(1)),
                                      "%s<%s>::%s" % (name, m.group(3), cm.group(1)), v))


_CONSTEXPR = re.compile(
    r"(?:static\s+)?constexpr\s+(?:unsigned\s+)?[\w:]+\s+(\w+)\s*=\s*([^;{}]+);")


def _eval_int(node, env):
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        v = env.get(node.id)
        return v if isinstance(v, int) else None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        v = _eval_int(node.operand, env)
        return None if v is None else (-v if isinstance(node.op, ast.USub) else v)
    if isinstance(node, ast.BinOp):
        a, b = _eval_int(node.left, env), _eval_int(node.right, env)
        if a is None or b is None:
            return None
        ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
               ast.Mult: lambda: a * b,
               ast.FloorDiv: lambda: int(a / b) if b else None,
               ast.Mod: lambda: a % b if b else None,
               ast.LShift: lambda: a << b, ast.RShift: lambda: a >> b,
               ast.BitAnd: lambda: a & b, ast.BitOr: lambda: a | b}
        f = ops.get(type(node.op))
        return f() if f else None
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("min", "max") and not node.keywords:
        vals = [_eval_int(a, env) for a in node.args]
        if None in vals or not vals:
            return None
        return (min if node.func.id == "min" else max)(vals)
    return None


def _launches(clean):
    """``(kernel, smem expr, offset)`` of every ``<<<...>>>`` launch."""
    for m in re.finditer(r"(\w+)\s*(?:<[^<>;]*>)?\s*<<<(.*?)>>>", clean, re.S):
        cfg = _split_top(m.group(2))
        yield m.group(1), (cfg[2] if len(cfg) >= 3 else "0"), m.start(1)


def _opted_in(clean):
    """Kernels given ``cudaFuncAttributeMaxDynamicSharedMemorySize``."""
    out = set()
    for m in re.finditer(r"cudaFuncSetAttribute\s*\(", clean):
        end = m.end()
        depth = 1
        while end < len(clean) and depth:
            depth += {"(": 1, ")": -1}.get(clean[end], 0)
            end += 1
        args = _split_top(clean[m.end():end - 1])
        if len(args) >= 2 and "MaxDynamicSharedMemorySize" in args[1]:
            km = re.match(r"(?:\w+::)*(\w+)", args[0])
            if km:
                out.add(km.group(1))
    return out


# ---------------------------------------------------------------------------
# the Python side: SIGNATURES and the lib.<entry>(...) calls
# ---------------------------------------------------------------------------


def _ctypes_kind(node, aliases):
    if isinstance(node, ast.Constant) and node.value is None:
        return "void"
    if isinstance(node, ast.Name) and node.id in aliases:
        return aliases[node.id]
    if isinstance(node, ast.Attribute):
        return _CTYPES_KIND.get(node.attr, "?" + node.attr)
    return None


def _ctypes_list(node, aliases):
    if isinstance(node, (ast.List, ast.Tuple)):
        kinds = [_ctypes_kind(e, aliases) for e in node.elts]
        return None if None in kinds else kinds
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _ctypes_list(node.left, aliases), _ctypes_list(node.right, aliases)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for lst, k in ((node.left, node.right), (node.right, node.left)):
            if isinstance(k, ast.Constant) and isinstance(k.value, int):
                inner = _ctypes_list(lst, aliases)
                return None if inner is None else inner * k.value
    return None


def signatures_of(tree: ast.Module):
    """``{lib: {entry: (return kind, [param kinds] or None, line)}}`` from
    ``_build.py``'s ``SIGNATURES`` literal."""
    aliases, sig = {}, None
    for s in tree.body:
        target = s.targets[0] if isinstance(s, ast.Assign) and len(s.targets) == 1 \
            else getattr(s, "target", None)
        if not isinstance(target, ast.Name) or getattr(s, "value", None) is None:
            continue
        if isinstance(s.value, ast.Attribute) and s.value.attr in _CTYPES_KIND:
            aliases[target.id] = _CTYPES_KIND[s.value.attr]
        if target.id == "SIGNATURES" and isinstance(s.value, ast.Dict):
            sig = s.value
    out = {}
    if sig is None:
        return out
    for lk, lv in zip(sig.keys, sig.values):
        if not (isinstance(lk, ast.Constant) and isinstance(lv, ast.Dict)):
            continue
        lib = out.setdefault(lk.value, {})
        for ek, ev in zip(lv.keys, lv.values):
            if isinstance(ek, ast.Constant) and isinstance(ev, ast.Tuple) \
                    and len(ev.elts) == 2:
                lib[ek.value] = (_ctypes_kind(ev.elts[0], aliases),
                                 _ctypes_list(ev.elts[1], aliases), ek.lineno)
    return out


class CAbiChecker:
    """Hold every ``kernels/_build.py`` of the linted sources against the
    ``csrc`` beside it. ``entries_held`` counts the SIGNATURES entries
    matched to a prototype; ``smem_sizes`` lists the evaluated sizes."""

    def __init__(self, engine, py_sources: dict, c_sources: dict):
        self.engine = engine
        self.py = py_sources
        self.c = {os.path.normpath(p): (p, t) for p, t in c_sources.items()}
        self.entries_held = 0
        self.smem_sizes = []

    def run(self):
        for path, text in self.py.items():
            if path.replace("\\", "/").endswith("kernels/_build.py"):
                self._check_build(path, text)
        done = set()
        for key, (path, text) in sorted(self.c.items()):
            if path.endswith(".cu"):
                self._check_tu(path, done)

    def _emit(self, path, line, msg):
        self.engine.emit("RA006", path, line, msg)

    def _tu(self, path):
        """The files of ``path``'s translation unit: local headers first."""
        order, seen = [], set()

        def visit(p):
            key = os.path.normpath(p)
            if key in seen or key not in self.c:
                return
            seen.add(key)
            orig, text = self.c[key]
            for inc in local_includes(text):
                visit(os.path.join(os.path.dirname(orig), inc))
            order.append((orig, strip_comments(text)))
        visit(path)
        return order

    def _check_tu(self, path, done):
        files = self._tu(path)
        env = _ConstEnv(files)
        opted = set()
        for _, clean in files:
            opted |= _opted_in(clean)
        for p, line, name, value in env.defs:
            if "smem" not in name.lower() or (p, line, name) in done:
                continue
            done.add((p, line, name))
            self.smem_sizes.append((p, line, name, value))
            if value > SMEM_OPT_IN_MAX:
                self._emit(p, line, "%s = %d bytes of shared memory is over the "
                           "H100's %d-byte opt-in maximum per block"
                           % (name, value, SMEM_OPT_IN_MAX))
        for p, clean in files:
            for kernel, smem, pos in _launches(clean):
                if smem == "0" or kernel in opted:
                    continue
                v = env.eval(smem)
                if v is not None and v <= SMEM_DEFAULT_MAX:
                    continue
                self._emit(p, _line(clean, pos),
                           "%s launched with %s bytes of dynamic shared memory and "
                           "no cudaFuncSetAttribute(%s, cudaFuncAttribute"
                           "MaxDynamicSharedMemorySize, ...) in its translation unit"
                           % (kernel, smem if v is None else v, kernel))

    def _check_build(self, path, text):
        try:
            tree = ast.parse(text, filename=path)
        except SyntaxError:
            return
        sigs = signatures_of(tree)
        csrc = os.path.join(os.path.dirname(path), "csrc")
        declared = {}
        for lib, entries in sigs.items():
            key = os.path.normpath(os.path.join(csrc, lib + ".cu"))
            if key not in self.c:
                continue
            cpath, ctext = self.c[key]
            protos = extern_c_entries(ctext)
            for entry, (ret, params, line) in entries.items():
                declared[entry] = params
                proto = protos.get(entry)
                if proto is None:
                    self._emit(path, line, "SIGNATURES['%s']['%s'] has no extern "
                               "\"C\" entry in %s" % (lib, entry, cpath))
                    continue
                self.entries_held += 1
                self._compare(cpath, lib, entry, proto, ret, params)
            for entry, (_, _, line) in protos.items():
                if entry not in entries:
                    self._emit(cpath, line, "extern \"C\" entry %s is not declared "
                               "in SIGNATURES['%s'] of %s" % (entry, lib, path))
        kdir = os.path.dirname(path)
        for p, t in self.py.items():
            if os.path.dirname(p) == kdir:
                self._check_calls(p, t, declared)

    def _compare(self, cpath, lib, entry, proto, ret, params):
        cret, cparams, line = proto
        where = "%s (SIGNATURES['%s'])" % (entry, lib)
        if ret is not None and ret != cret:
            self._emit(cpath, line, "%s returns %s in C but restype is %s"
                       % (where, cret, ret))
        if params is None:
            return
        if len(params) != len(cparams):
            self._emit(cpath, line, "%s takes %d parameters in C but argtypes "
                       "declares %d" % (where, len(cparams), len(params)))
            return
        for i, (c, py) in enumerate(zip(cparams, params)):
            if c != py:
                self._emit(cpath, line, "%s parameter %d is %s in C but %s in "
                           "argtypes" % (where, i, c, py))

    def _check_calls(self, path, text, declared):
        try:
            tree = ast.parse(text, filename=path)
        except SyntaxError:
            return
        for n in ast.walk(tree):
            if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and n.func.attr in declared):
                continue
            params = declared[n.func.attr]
            if params is None or n.keywords or any(
                    isinstance(a, ast.Starred) for a in n.args):
                continue
            if len(n.args) != len(params):
                self.engine.emit(
                    "RA006", path, n.lineno,
                    "%s(...) passes %d arguments but SIGNATURES declares %d"
                    % (n.func.attr, len(n.args), len(params)))
