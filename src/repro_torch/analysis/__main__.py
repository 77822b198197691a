"""CLI: ``python -m repro_torch.analysis [--check] [--json PATH] PATHS...``"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.findings import findings_json
from repro_torch.analysis.linter import lint_paths

DEFAULT = "src/repro_torch"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="The port's eager-PyTorch/CUDA lint pass (rules RA001-RA006).",
    )
    ap.add_argument("paths", nargs="*", default=[DEFAULT], help="files or directories")
    ap.add_argument(
        "--check", action="store_true",
        help="exit non-zero if any unwaived finding remains",
    )
    ap.add_argument("--json", metavar="PATH", help="write machine-readable findings")
    ap.add_argument(
        "--show-waived", action="store_true",
        help="also print findings suppressed by repro-lint waivers",
    )
    ns = ap.parse_args(argv)

    stats = {}
    findings = lint_paths(ns.paths or [DEFAULT], stats)
    unwaived = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]

    for f in unwaived:
        print(f.render())
    if ns.show_waived:
        for f in waived:
            print(f.render())

    if ns.json:
        with open(ns.json, "w", encoding="utf-8") as fh:
            fh.write(findings_json(findings) + "\n")

    print(
        "repro_torch.analysis: %d finding(s), %d unwaived, %d waived; "
        "%d C entry point(s) held against SIGNATURES"
        % (len(findings), len(unwaived), len(waived), stats["c_entries"]),
        file=sys.stderr,
    )
    if ns.check and unwaived:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
