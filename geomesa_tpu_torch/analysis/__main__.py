"""``python -m geomesa_tpu_torch.analysis`` — the gm-lint CLI.

Exit codes: 0 = clean (or, with ``--fail-on-new``, nothing beyond the
baseline); 1 = findings (new findings under ``--fail-on-new``); 2 =
usage/baseline error.  Stays stdlib-only end to end (package doc), so
it runs where neither torch nor numpy is installed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import all_checks
from .baseline import Baseline, BaselineError, DEFAULT_BASELINE_PATH
from .walker import PACKAGE_ROOT, _in_analysis_dir, analyze


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m geomesa_tpu_torch.analysis",
        description="gm-lint: AST-based invariant analysis "
                    "(docs/static_analysis.md)")
    p.add_argument("paths", nargs="*", type=Path,
                   help="files/directories to analyze "
                        "(default: the geomesa_tpu_torch package)")
    p.add_argument("--check", action="append", dest="checks",
                   metavar="ID", help="run only this check (repeatable)")
    p.add_argument("--list-checks", action="store_true",
                   help="print the check catalog and exit")
    p.add_argument("--fail-on-new", action="store_true",
                   help="fail only on findings absent from the baseline")
    p.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE_PATH,
                   help="baseline ledger path (default: the committed "
                        "analysis/baseline.json)")
    p.add_argument("--write-baseline", metavar="JUSTIFICATION",
                   help="write the current findings to --baseline, all "
                        "carrying this justification, and exit 0")
    p.add_argument("--format", choices=("text", "json"), default="text")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    checks = all_checks()
    if args.list_checks:
        if args.format == "json":
            print(json.dumps([{"id": c.id, "description": c.description}
                              for c in checks], indent=1))
        else:
            for c in checks:
                print(f"{c.id:18} {c.description}")
        return 0
    if args.checks:
        known = {c.id for c in checks}
        bad = [c for c in args.checks if c not in known]
        if bad:
            print(f"unknown check(s): {', '.join(bad)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 2
        checks = [c for c in checks if c.id in set(args.checks)]
    roots = args.paths or [PACKAGE_ROOT]
    t0 = time.perf_counter()
    findings = []
    for root in roots:
        if not root.exists():
            print(f"no such path: {root}", file=sys.stderr)
            return 2
        if _in_analysis_dir(root):
            # loud, not a silent 0-findings "clean": the analyzer's
            # own tree is excluded (self-referential pattern literals)
            print(f"{root}: the analyzer's own package is excluded "
                  f"from analysis", file=sys.stderr)
            return 2
        findings.extend(analyze(root, checks=checks))
    elapsed = time.perf_counter() - t0
    if args.write_baseline:
        if args.checks or args.paths:
            # a subset write would drop every entry the subset cannot
            # see — the ledger is only regenerable from a full run
            print("--write-baseline requires a full default run "
                  "(no --check / paths)", file=sys.stderr)
            return 2
        ledger = Baseline.from_findings(findings, args.write_baseline)
        try:
            prior = Baseline.load(args.baseline)
        except BaselineError:
            prior = Baseline()
        for key in ledger.entries:
            if key in prior.entries:  # keep the written-down WHY
                ledger.entries[key] = prior.entries[key]
        ledger.save(args.baseline)
        print(f"wrote {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} to {args.baseline}")
        return 0
    new, baselined, stale = findings, [], []
    if args.fail_on_new:
        try:
            ledger = Baseline.load(args.baseline)
        except BaselineError as e:
            print(f"baseline error: {e}", file=sys.stderr)
            return 2
        new, baselined, stale = ledger.split(findings)
        if args.checks or args.paths:
            # a check/path SUBSET cannot see every baselined site —
            # reporting its unmatched entries as stale invites
            # deleting load-bearing ledger rows
            stale = []
    if args.format == "json":
        print(json.dumps({
            "elapsed_s": round(elapsed, 3),
            "checks": [c.id for c in checks],
            "findings": [f.to_json() for f in new],
            "baselined": [f.to_json() for f in baselined],
            "stale_baseline": [list(k) for k in stale],
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        if baselined:
            print(f"# {len(baselined)} baselined finding(s) "
                  f"(analysis/baseline.json)")
        for key in stale:
            print(f"# stale baseline entry (no longer found): {key}")
        print(f"# {len(new)} finding(s), {len(checks)} check(s), "
              f"{elapsed:.2f}s")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
