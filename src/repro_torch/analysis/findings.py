"""Finding records and the repro-lint waiver directive syntax.

The port's own copy of ``repro.analysis.findings``: the same directive
grammar, the same records and the same JSON payload, so the reference's
linter and this one read every waiver in ``src/repro_torch`` the same way.
Only the rule meanings differ (eager PyTorch, CUDA graphs and the C
kernel ABI instead of jit, ``shard_map`` and Pallas); the codes are the
same RA000-RA006.

A finding is (rule, file, line, message). Waivers attach at the line of
the finding or the line directly above, as a comment of the form
``repro-lint: disable=RA003 (deliberate sync point)`` — one or more
rule codes, comma-separated, followed by a parenthesized reason.
File-level waivers use ``disable-file=`` instead and sit anywhere in
the file. A reason ends at its first ``)``, as in the reference.

A waiver with no ``(reason)`` does not suppress anything — it is
reported as an RA000 finding of its own, so every suppression in the
tree carries a written justification.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field

RULES = {
    "RA000": "malformed waiver (missing reason or unknown rule)",
    "RA001": ("Python control flow on a tensor in capture- or "
              "sync-free-reachable code"),
    "RA002": ("impure call (global RNG / time / I/O) in capture-reachable "
              "code, or a draw without an explicit generator"),
    "RA003": "implicit host<->device sync in sync-free-reachable or hot serving code",
    "RA004": "buffer used before its asynchronous hand-off completed",
    "RA005": ("rebuild hazard (graph / stream / generator / pinned buffer "
              "built per call)"),
    "RA006": ("C kernel ABI or launch contract violation (csrc/*.cu "
              "against _build.py)"),
}

_WAIVER_RE = re.compile(
    r"#\s*repro-lint:\s*(?P<kind>disable|disable-file)\s*=\s*"
    r"(?P<codes>RA\d{3}(?:\s*,\s*RA\d{3})*)\s*"
    r"(?:\((?P<reason>[^)]*)\))?"
)
_DIRECTIVE_RE = re.compile(r"#\s*repro-lint\s*:")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    waived: bool = False
    waiver_reason: str = ""

    def render(self) -> str:
        tag = " [waived: %s]" % self.waiver_reason if self.waived else ""
        return "%s:%d: %s %s%s" % (self.path, self.line, self.rule, self.message, tag)


@dataclass
class Waivers:
    """Parsed waiver directives for one source file."""

    # line -> {code -> reason}; file_level: code -> reason
    by_line: dict = field(default_factory=dict)
    file_level: dict = field(default_factory=dict)
    malformed: list = field(default_factory=list)  # [(line, message)]
    used: set = field(default_factory=set)  # (line, code) pairs that suppressed

    def lookup(self, line: int, code: str):
        """Return the waiver reason covering ``code`` at ``line``, else None."""
        if code in self.file_level:
            return self.file_level[code]
        for probe in (line, line - 1):
            reason = self.by_line.get(probe, {}).get(code)
            if reason is not None:
                self.used.add((probe, code))
                return reason
        return None


def parse_waivers(text: str) -> Waivers:
    w = Waivers()
    for lineno, raw in enumerate(text.splitlines(), start=1):
        m = _WAIVER_RE.search(raw)
        if m is None:
            if _DIRECTIVE_RE.search(raw):
                w.malformed.append((lineno, "unparseable repro-lint directive"))
            continue
        codes = [c.strip() for c in m.group("codes").split(",")]
        reason = (m.group("reason") or "").strip()
        if not reason:
            w.malformed.append((lineno, "waiver for %s has no (reason)" % ",".join(codes)))
            continue
        bad = [c for c in codes if c not in RULES or c == "RA000"]
        if bad:
            w.malformed.append((lineno, "waiver names unknown rule %s" % ",".join(bad)))
            continue
        target = w.file_level if m.group("kind") == "disable-file" else w.by_line.setdefault(lineno, {})
        for code in codes:
            target[code] = reason
    return w


def apply_waivers(findings: list, waivers: Waivers, path: str) -> list:
    """Mark waived findings in place; append RA000s for malformed waivers."""
    for f in findings:
        reason = waivers.lookup(f.line, f.rule)
        if reason is not None:
            f.waived = True
            f.waiver_reason = reason
    out = list(findings)
    for line, msg in waivers.malformed:
        out.append(Finding("RA000", path, line, msg))
    return out


def findings_json(findings: list) -> str:
    payload = {
        "rules": RULES,
        "total": len(findings),
        "unwaived": sum(1 for f in findings if not f.waived),
        "findings": [asdict(f) for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))],
    }
    return json.dumps(payload, indent=2, sort_keys=False)
