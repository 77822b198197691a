"""Driver: files -> Program -> rules -> waiver-filtered findings.

Python files are linted as one program; RA006 also reads the ``.cu`` and
``.cuh`` files under the same paths (:mod:`repro_torch.analysis.cabi`).
"""

from __future__ import annotations

import os
import re

from repro_torch.analysis.cabi import CAbiChecker
from repro_torch.analysis.findings import Finding, apply_waivers, parse_waivers
from repro_torch.analysis.reachability import Program, index_module
from repro_torch.analysis.rules import RuleEngine

_C_SUFFIXES = (".cu", ".cuh")


def _walk(paths, suffixes):
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for f in sorted(files):
                    if f.endswith(suffixes):
                        out.append(os.path.join(root, f))
        elif p.endswith(suffixes):
            out.append(p)
    return out


def _collect_files(paths):
    return _walk(paths, ".py")


def _collect_c_files(paths):
    return _walk(paths, _C_SUFFIXES)


def _c_waivers(text):
    """The waiver grammar behind ``//`` in a C source."""
    return parse_waivers(re.sub(r"//(\s*repro-lint\s*:)", r"#\1", text))


def lint_sources(sources, c_sources=None, stats=None):
    """Lint {path: text} pairs together as one program, with the C
    sources ``c_sources`` ({path: text}) for RA006.

    Returns the full findings list (waived findings included, marked).
    ``stats``, when given a dict, receives the counts of what was read.
    """
    c_sources = c_sources or {}
    modules = []
    findings = []
    for path, text in sources.items():
        try:
            modules.append(index_module(path, text))
        except SyntaxError as e:
            findings.append(
                Finding("RA000", path, e.lineno or 0, "syntax error: %s" % e.msg)
            )
    program = Program(modules)
    engine = RuleEngine(program)
    for idx in modules:
        engine.check_module(idx)
    cabi = CAbiChecker(engine, sources, c_sources)
    cabi.run()
    by_path = {}
    for f in engine.findings:
        by_path.setdefault(f.path, []).append(f)
    for path, text in sources.items():
        waivers = parse_waivers(text)
        findings.extend(apply_waivers(by_path.get(path, []), waivers, path))
    for path, text in c_sources.items():
        findings.extend(apply_waivers(by_path.get(path, []), _c_waivers(text), path))
    if stats is not None:
        stats.update(files=len(sources), c_files=len(c_sources),
                     capture_reachable=len(program.capture),
                     sync_free_reachable=len(program.sync_free),
                     c_entries=cabi.entries_held,
                     smem_sizes=[("%s:%s" % (os.path.basename(p), n), v)
                                 for p, _, n, v in cabi.smem_sizes])
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def _read(files):
    out = {}
    for path in files:
        with open(path, "r", encoding="utf-8") as fh:
            out[path] = fh.read()
    return out


def lint_paths(paths, stats=None):
    return lint_sources(_read(_collect_files(paths)),
                        _read(_collect_c_files(paths)), stats)


def lint_text(text, path="fixture.py"):
    """Lint a single in-memory module (test fixtures)."""
    return lint_sources({path: text})
