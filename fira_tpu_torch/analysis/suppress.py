"""Suppression comments: ``# firacheck: allow[RULE-ID] <reason>``
(counterpart of ``fira_tpu/analysis/suppress.py``, the same directive:
a waiver in the port parses under both analyzers).

An inline comment waives the named rule(s) on its own line; a standalone
comment line waives them on the next source line (consecutive standalone
waivers stack onto the same target). The reason is MANDATORY and must name
the invariant being waived — a bare ``allow[...]`` is itself a
BAD-SUPPRESS error, so the committed baseline can't rot into cargo-cult
silencing. Multiple rules: ``allow[HOST-SYNC,RETRACE] reason``.

Suppressions are per-rule by construction: ``allow[DISCARDED-AT]`` never
silences a HOST-SYNC finding on the same line (pinned by
tests/test_torch_analysis.py).
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, List, Tuple

from fira_tpu_torch.analysis.findings import RULES, Finding, Severity

_ALLOW_RE = re.compile(
    r"#\s*firacheck:\s*allow\[(?P<rules>[^\]]*)\]\s*(?P<reason>.*)$")
_MARKER_RE = re.compile(r"#\s*firacheck\b")


@dataclasses.dataclass
class Suppression:
    line: int            # line the comment sits on
    target: int          # line whose findings it waives
    rules: Tuple[str, ...]
    reason: str
    # usage is tracked PER RULE: allow[A,B] where only A ever matches must
    # still report B as stale, or the baseline stops shrinking
    used_rules: set = dataclasses.field(default_factory=set)


def _comments(source: str) -> List[Tuple[int, int, str]]:
    """(line, col, text) for every comment token; tolerant of files that
    tokenize cannot finish (returns what it saw before the error)."""
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def parse_suppressions(path: str, source: str
                       ) -> Tuple[List[Suppression], List[Finding]]:
    """Extract suppressions + BAD-SUPPRESS findings for malformed ones."""
    lines = source.splitlines()

    def next_code_line(after: int) -> int:
        for i in range(after, len(lines)):
            stripped = lines[i].strip()
            if stripped and not stripped.startswith("#"):
                return i + 1  # 1-based
        return after  # trailing comment: waives nothing real

    sups: List[Suppression] = []
    bad: List[Finding] = []
    for line, col, text in _comments(source):
        if not _MARKER_RE.search(text):
            continue
        m = _ALLOW_RE.search(text)
        if not m:
            bad.append(Finding(path, line, "BAD-SUPPRESS", Severity.ERROR,
                               f"unrecognized firacheck directive {text!r}; "
                               f"expected '# firacheck: allow[RULE-ID] "
                               f"<reason>'"))
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        reason = m.group("reason").strip()
        unknown = [r for r in rules if r not in RULES]
        if not rules or unknown:
            bad.append(Finding(path, line, "BAD-SUPPRESS", Severity.ERROR,
                               f"unknown rule id(s) {unknown or '[]'} in "
                               f"suppression; known: {sorted(RULES)}"))
            continue
        if not reason:
            bad.append(Finding(path, line, "BAD-SUPPRESS", Severity.ERROR,
                               "suppression without a reason; name the "
                               "invariant this waiver trades away"))
            continue
        standalone = lines[line - 1].strip().startswith("#")
        target = next_code_line(line) if standalone else line
        sups.append(Suppression(line, target, rules, reason))
    return sups, bad


def apply_suppressions(findings: List[Finding], sups: List[Suppression]
                       ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, waived); marks suppressions used."""
    by_target: Dict[Tuple[int, str], List[Suppression]] = {}
    for s in sups:
        for r in s.rules:
            by_target.setdefault((s.target, r), []).append(s)
    kept, waived = [], []
    for f in findings:
        hits = by_target.get((f.line, f.rule))
        if hits:
            for s in hits:
                s.used_rules.add(f.rule)
            waived.append(f)
        else:
            kept.append(f)
    return kept, waived


def unused_suppressions(path: str, sups: List[Suppression]) -> List[Finding]:
    """A waiver (or a rule within a multi-rule waiver) that waives nothing
    is stale — surface it (warning) so the baseline shrinks when hazards
    get fixed for real."""
    out = []
    for s in sups:
        stale = [r for r in s.rules if r not in s.used_rules]
        if stale:
            out.append(Finding(
                path, s.line, "BAD-SUPPRESS", Severity.WARNING,
                f"unused suppression for {','.join(stale)} (no matching "
                f"finding on line {s.target}); delete it"))
    return out
