"""replint CLI for the port: `python -m repro_torch.analysis.lint
src/repro_torch`.

Exit code 0 when every finding is suppressed (with a written reason), 1
when any unsuppressed finding remains, 2 on a usage error (argparse), as
the JAX package's CLI.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.analysis.core import run_lint
from repro_torch.analysis.rules import ALL_RULES


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="replint for the port: the determinism / "
                    "capture-once / host-sync / protocol / metric-schema "
                    "contract checker (README.md, Lint)")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to scan (default: src)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="report format (json includes suppressed "
                         "findings and unused suppressions)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run "
                         "(e.g. R001,R004); default: all")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings in text mode")
    ap.add_argument("--output", default=None,
                    help="write the report to a file instead of stdout")
    args = ap.parse_args(argv)

    rules = [cls() for cls in ALL_RULES]
    if args.rules:
        want = {r.strip().upper() for r in args.rules.split(",")}
        unknown = want - {r.id for r in rules}
        if unknown:
            ap.error(f"unknown rule id(s): {', '.join(sorted(unknown))}")
        rules = [r for r in rules if r.id in want]

    result = run_lint(args.paths, rules)
    report = (result.format_json() if args.format == "json"
              else result.format_text(show_suppressed=args.show_suppressed))
    if args.output:
        with open(args.output, "w") as f:
            f.write(report + "\n")
    else:
        print(report)
    return 1 if result.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
