"""firacheck CLI for the port (counterpart of
``fira_tpu/analysis/cli.py``: the same subcommands, flags, output format
and exit codes).

Usage:
    python -m fira_tpu_torch.analysis.cli check fira_tpu_torch
    python -m fira_tpu_torch.analysis.cli check --no-suppress fira_tpu_torch
    python -m fira_tpu_torch.analysis.cli check --json fira_tpu_torch
    python -m fira_tpu_torch.analysis.cli check --rules SHARED-MUT,FAULT-SITE fira_tpu_torch
    python -m fira_tpu_torch.analysis.cli check --sarif out.sarif fira_tpu_torch
    python -m fira_tpu_torch.analysis.cli list-rules

``check`` prints one ``file:line [RULE-ID] severity: message`` per finding
and exits 1 if any ERROR survives the suppression baseline (warnings never
gate). ``--no-suppress`` shows the raw pre-waiver findings — the view a
reviewer uses to audit the committed baseline. ``--json`` emits one
machine-readable document on stdout (per-rule counts + a findings
array); ``--rules`` restricts reporting AND the
exit status to the named rule ids, so a scan leg can gate on one rule
family without re-litigating the whole baseline. ``--sarif PATH``
additionally writes the findings as a SARIF 2.1.0 log to PATH — the
interchange format code-review UIs ingest — without changing what goes
to stdout or the exit status. ``list-rules`` prints every rule id, the
ones with no torch form (DONATION) with the reason they are not checked.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from fira_tpu_torch.analysis import astutil, engine
from fira_tpu_torch.analysis.findings import RULES, Severity


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fira_tpu_torch.analysis.cli",
                                description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    chk = sub.add_parser("check", help="analyze paths; exit 1 on errors")
    chk.add_argument("paths", nargs="+",
                     help="files or directories to analyze")
    chk.add_argument("--no-suppress", action="store_true",
                     help="show raw pre-waiver findings (audit view for "
                          "the committed baseline). The exit status then "
                          "reflects the RAW findings too, so a cleanly "
                          "baselined repo may still exit 1 here")
    chk.add_argument("--quiet", action="store_true",
                     help="suppress the summary line")
    chk.add_argument("--json", action="store_true",
                     help="emit one machine-readable JSON document on "
                          "stdout: {files, errors, warnings, per_rule, "
                          "findings: [{path, line, rule, severity, "
                          "message}]}. Exit codes are unchanged")
    chk.add_argument("--sarif", default=None, metavar="PATH",
                     help="also write the findings as a SARIF 2.1.0 log "
                          "to PATH (stdout output and exit codes are "
                          "unchanged; composes with --rules/--json)")
    chk.add_argument("--rules", default=None, metavar="RULE[,RULE...]",
                     help="restrict reporting and exit status to these "
                          "rule ids (BAD-SUPPRESS and PARSE-ERROR always "
                          "gate — a waiver typo or a broken file must "
                          "never pass a filtered scan). Unknown ids are "
                          "a usage error (exit 2)")
    sub.add_parser("list-rules", help="print the rule registry")
    return p


# always-gating meta rules: a filtered scan that ignored a malformed
# waiver or an unparseable file would report "clean" over a scan that
# never actually ran
_META_RULES = ("BAD-SUPPRESS", "PARSE-ERROR")

_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                 "master/Schemata/sarif-schema-2.1.0.json")


def sarif_document(findings, rule_ids) -> dict:
    """The findings as one SARIF 2.1.0 run. ``rule_ids`` is the reported
    rule universe (the --rules selection or the full registry): every id
    appears in the driver's rules array whether or not it fired, so a
    consumer can tell "rule ran clean" from "rule didn't run"."""
    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "firacheck",
                "informationUri": "docs/ANALYSIS_TORCH.md",
                "rules": [{"id": r,
                           "shortDescription": {"text": RULES[r]}}
                          for r in sorted(rule_ids)],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": str(f.severity),
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace("\\", "/")},
                    "region": {"startLine": f.line},
                }}],
            } for f in findings],
        }],
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "list-rules":
        for rule, doc in sorted(RULES.items()):
            print(f"{rule}: {doc}")
        return 0

    selected = None
    if args.rules:
        selected = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = sorted(selected - set(RULES))
        if unknown:
            print(f"firacheck: unknown rule id(s) {unknown}; known: "
                  f"{sorted(RULES)}", file=sys.stderr)
            return 2
        selected |= set(_META_RULES)

    # resolve the file list once; check_paths' own iter_py_files pass over
    # already-resolved .py paths is a cheap isfile sweep, not a re-walk.
    # An argument resolving to NO files gates: a mistyped or renamed path
    # must not turn into a silently-green scan over nothing
    files = []
    empty = []
    seen = set()
    for p in args.paths:
        got = engine.iter_py_files([p])
        if not got:
            empty.append(p)
        for f in got:
            # dedupe: a file named explicitly AND reached via a directory
            # argument (e.g. the self-scan pinning data/feeder.py alongside
            # the fira_tpu_torch tree) must not double-report findings
            key = astutil.normalize_path(f)
            if key not in seen:
                seen.add(key)
                files.append(f)
    if empty:
        print(f"firacheck: no Python files under {', '.join(empty)} — "
              f"refusing to report a clean scan over nothing",
              file=sys.stderr)
        return 1
    findings = engine.check_paths(files, suppress=not args.no_suppress)
    if selected is not None:
        findings = [f for f in findings if f.rule in selected]
    n_err = sum(1 for f in findings if f.severity is Severity.ERROR)
    n_warn = len(findings) - n_err
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(sarif_document(findings, selected or set(RULES)),
                      fh, indent=1)
            fh.write("\n")
    if args.json:
        per_rule = {r: 0 for r in sorted(selected or RULES)}
        for f in findings:
            per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
        json.dump({
            "files": len(files),
            "errors": n_err,
            "warnings": n_warn,
            "per_rule": per_rule,
            "findings": [{"path": f.path, "line": f.line, "rule": f.rule,
                          "severity": str(f.severity),
                          "message": f.message} for f in findings],
        }, sys.stdout, indent=1)
        print()
    else:
        for f in findings:
            print(f.render())
    if not args.quiet:
        print(f"firacheck: {n_err} error(s), {n_warn} warning(s) over "
              f"{len(files)} file(s)", file=sys.stderr)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
