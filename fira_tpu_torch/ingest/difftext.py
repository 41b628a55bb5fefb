"""Diff-text front end: raw unified git diff <-> (difftoken, diffmark)
(the port's copy of the JAX package's ``ingest/difftext.py``).

The corpus pipeline starts from pre-tokenized ``difftoken.json`` /
``diffmark.json`` streams (the crawl stage's output); a real user sends a
RAW unified diff. This module is the bridge, in both directions:

- :func:`parse_request` — unified-diff text -> the aligned
  ``(difftoken, diffmark)`` streams ``preprocess/fsm.split_hunks``
  consumes. File headers (``diff --git`` / ``---`` / ``+++`` / mode
  lines) are metadata and skipped; each ``@@ -a,b +c,d @@ section``
  hunk header becomes a ``<nb> ... <nl>`` block (the reference's header
  sentinels — git's section text IS the enclosing-declaration header
  FIRA keeps there), and each body line's content is lexed with the
  native Java lexer (``astdiff_binding.tokenize`` — the javalang
  stand-in the rest of preprocessing already uses) under mark 2
  (context, ``' '``), 1 (delete, ``'-'``), or 3 (add, ``'+'``).
  Optional ``#!`` metadata lines carry a reference message
  (``#! msg: fix npe``) and a variable-anonymization map
  (``#! var: {"getUserName": "STRING3"}``) — present on reconstructed
  corpus requests, absent on real traffic.
- :func:`reconstruct_diff` / :func:`reconstruct_request` — the inverse:
  a corpus commit's token/mark streams rendered back into a canonical
  unified diff (one body line per same-mark token run, tokens space-
  joined). ``parse_request(reconstruct_request(record))`` reproduces the
  record's streams exactly (tests/test_torch_ingest.py), which is
  what makes the ingest round-trip equivalence contract (docs/INGEST.md)
  testable end-to-end: reconstructed diff -> ingest -> byte-identical
  wire payload vs the frozen corpus path.

Line boundaries deliberately do NOT round-trip — only the (token, mark)
streams do. The FSM merges consecutive same-mark tokens into one run
regardless of the lines they arrived on, so splitting a run across body
lines is a no-op downstream.

Trace I/O: :func:`read_diff_trace` / :func:`write_diff_trace` handle the
request sources of ``cli serve --input diffs``: a single file of
``#! request``-separated diffs, or a directory of ``*.diff`` files served
in sorted name order.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

from fira_tpu_torch.preprocess import astdiff_binding as astdiff
from fira_tpu_torch.preprocess.fsm import NB, NL


class DiffParseError(ValueError):
    """Malformed diff text, named with its line: ``cli message`` rejects
    the request with it (exit 1), and the serving loop's poison-request
    quarantine sheds it with the reason recorded, never a crash
    (docs/INGEST.md)."""


# one unified-diff hunk header; group(1) is git's trailing section text
# (the enclosing declaration — FIRA's <nb> header block content)
_HUNK_RE = re.compile(r"^@@\s+-\d+(?:,\d+)?\s+\+\d+(?:,\d+)?\s+@@(.*)$")

# file-level metadata lines: request framing, not diff content. Only
# honored OUTSIDE a hunk (after `diff --git` / before the first `@@`) —
# inside a hunk a line starting with "--- " is a deletion whose content
# begins with "--" (git disambiguates by position, so must we).
_FILE_HEADER_PREFIXES = (
    "diff --git", "index ", "--- ", "+++ ", "new file mode",
    "deleted file mode", "old mode", "new mode", "similarity index",
    "dissimilarity index", "rename from", "rename to", "copy from",
    "copy to", "Binary files",
)
# skippable anywhere: git emits this marker INSIDE hunks, and its
# leading backslash can never collide with a body-line marker
_ANYWHERE_SKIP_PREFIXES = ("\\ No newline",)

_MARK_BY_CHAR = {" ": 2, "-": 1, "+": 3}
_CHAR_BY_MARK = {2: " ", 1: "-", 3: "+"}


@dataclasses.dataclass
class DiffRequest:
    """One parsed raw-diff request: the aligned token/mark streams plus
    the optional ``#!`` metadata (empty for real traffic — the message
    is what the model generates, and anonymization maps only exist for
    corpus-reconstructed requests)."""

    tokens: List[str]
    marks: List[int]
    msg_tokens: List[str]
    var_map: Dict[str, str]


def _lex(text: str, where: str, lex=None) -> List[str]:
    if not text.strip():
        return []
    toks = (lex or astdiff.tokenize)(text)
    if toks is None:
        raise DiffParseError(f"{where}: unlexable content {text!r}")
    return toks


def parse_request(text: str, *, lex=None) -> DiffRequest:
    """Raw request text -> :class:`DiffRequest`. Raises
    :class:`DiffParseError` (with the offending line number) on anything
    that is not a unified diff: a body line before any ``@@`` hunk
    header, an unknown marker character, malformed ``#!`` metadata, or a
    request with no diff content at all.

    ``lex``: a text -> tokens callable in place of the native lexer (the
    ingest fast path passes ``ingest.cache.LexMemo``: a repeated body line
    lexes once a process), with the bare lexer's output."""
    tokens: List[str] = []
    marks: List[int] = []
    msg_tokens: List[str] = []
    var_map: Dict[str, str] = {}
    in_hunk = False
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip("\r")
        if line.startswith("#!"):
            meta = line[2:].strip()
            if meta.startswith("msg:"):
                msg_tokens = meta[len("msg:"):].split()
            elif meta.startswith("var:"):
                try:
                    var_map = json.loads(meta[len("var:"):])
                except json.JSONDecodeError as e:
                    raise DiffParseError(
                        f"line {ln}: '#! var:' payload is not JSON: {e}"
                    ) from None
                if not isinstance(var_map, dict) or not all(
                        isinstance(k, str) and isinstance(v, str)
                        for k, v in var_map.items()):
                    raise DiffParseError(
                        f"line {ln}: '#! var:' payload must be a "
                        f"{{original: placeholder}} string map")
            elif meta.startswith("request"):
                continue  # trace separator riding inside a request text
            else:
                raise DiffParseError(
                    f"line {ln}: unknown '#!' metadata {line!r} (known: "
                    f"'#! msg: ...', '#! var: {{...}}', '#! request')")
            continue
        if not line.strip():
            continue
        if any(line.startswith(p) for p in _ANYWHERE_SKIP_PREFIXES):
            continue
        if line.startswith("diff --git"):
            in_hunk = False  # a new file section: headers follow
            continue
        if not in_hunk and any(line.startswith(p)
                               for p in _FILE_HEADER_PREFIXES):
            continue
        m = _HUNK_RE.match(line)
        if m:
            in_hunk = True
            section = m.group(1).strip()
            if section:
                toks = _lex(section, f"line {ln}", lex)
                if toks:
                    tokens += [NB] + toks + [NL]
                    marks += [2] * (len(toks) + 2)
            continue
        c = line[0]
        if c not in _MARK_BY_CHAR:
            raise DiffParseError(
                f"line {ln}: {line!r} is neither a diff body line "
                f"(' '/'-'/'+'), a file header, nor an @@ hunk header")
        if not in_hunk:
            raise DiffParseError(
                f"line {ln}: diff body line before any @@ hunk header")
        toks = _lex(line[1:], f"line {ln}", lex)
        tokens += toks
        marks += [_MARK_BY_CHAR[c]] * len(toks)
    if not tokens:
        raise DiffParseError("no diff content (no tokens in any hunk)")
    return DiffRequest(tokens=tokens, marks=marks, msg_tokens=msg_tokens,
                       var_map=var_map)


# --------------------------------------------------------------------------
# reconstruction (corpus streams -> canonical diff text)
# --------------------------------------------------------------------------

def reconstruct_diff(tokens: Sequence[str], marks: Sequence[int]) -> str:
    """Render corpus ``(difftoken, diffmark)`` streams as a canonical
    unified diff whose :func:`parse_request` output reproduces the
    streams exactly. ``<nb> ... <nl>`` blocks become hunk headers with
    the block's tokens as section text; each maximal same-mark token run
    becomes one space-joined body line. Raises ValueError on streams it
    cannot represent (an empty ``<nb>`` block, a stray ``<nl>``) — a
    corpus-quality problem, not a request-path one."""
    if len(tokens) != len(marks):
        raise ValueError(f"token/mark length mismatch: "
                         f"{len(tokens)} vs {len(marks)}")
    lines = ["diff --git a/commit.java b/commit.java",
             "--- a/commit.java", "+++ b/commit.java"]
    run: List[str] = []
    run_mark = None
    saw_hunk = False

    def flush() -> None:
        if run:
            # a SPACE separates the marker from the content: a run whose
            # first token is "--"/"++" would otherwise render as
            # "--- ..."/"+++ ..." and be skipped as a file header on
            # re-parse (lexing is whitespace-insensitive, so the extra
            # space round-trips exactly)
            lines.append(_CHAR_BY_MARK[run_mark] + " " + " ".join(run))

    toks = list(tokens)
    i, n = 0, len(toks)
    while i < n:
        t = toks[i]
        if t == NB:
            flush()
            run, run_mark = [], None
            # ONE forward walk to the closing <nl>, collecting the inner
            # tokens and checking marks in the same scan — index() plus
            # two re-slices walked every header block three times, and
            # header blocks are one per hunk on many-hunk diffs
            inner: List[str] = []
            bad_mark = marks[i] != 2
            j = i + 1
            while j < n and toks[j] != NL:
                inner.append(toks[j])
                bad_mark = bad_mark or marks[j] != 2
                j += 1
            if j >= n:
                raise ValueError(f"<nb> at {i} without closing <nl>")
            if bad_mark or marks[j] != 2:
                raise ValueError(f"non-context mark inside <nb> block at {i}")
            if not inner:
                raise ValueError(
                    f"empty <nb> block at {i}: an empty header block has "
                    f"no diff-text representation")
            lines.append(f"@@ -1,1 +1,1 @@ {' '.join(inner)}")
            saw_hunk = True
            i = j + 1
            continue
        if t == NL:
            raise ValueError(f"stray <nl> at {i} outside a <nb> block")
        if not saw_hunk:
            # a stream not opening with a header block still needs a hunk
            # delimiter; a bare header contributes no tokens on re-parse
            lines.append("@@ -1,1 +1,1 @@")
            saw_hunk = True
        m = marks[i]
        if m not in _CHAR_BY_MARK:
            raise ValueError(f"mark {m!r} at {i} outside {{1,2,3}}")
        if m != run_mark:
            flush()
            run, run_mark = [], m
        run.append(t)
        i += 1
    flush()
    return "\n".join(lines) + "\n"


def reconstruct_request(record) -> str:
    """One corpus commit (:class:`data.schema.CommitRecord`) as a full
    request text: ``#!`` metadata (reference message + anonymization
    map, when present) followed by the reconstructed diff — the
    round-trip input of the ingest equivalence contract."""
    head: List[str] = []
    if record.msg_tokens:
        head.append("#! msg: " + " ".join(record.msg_tokens))
    if record.var_map:
        head.append("#! var: " + json.dumps(record.var_map, sort_keys=True))
    body = reconstruct_diff(record.diff_tokens, record.diff_marks)
    return "\n".join(head + [body]) if head else body


# --------------------------------------------------------------------------
# diff-trace I/O (cli serve --input diffs)
# --------------------------------------------------------------------------

_REQUEST_SEP = "#! request"


def write_diff_trace(path: str, requests: Sequence[str]) -> str:
    """Write a file-of-diffs trace: each request prefixed by a
    ``#! request <i>`` separator line."""
    with open(path, "w") as f:
        for i, req in enumerate(requests):
            f.write(f"{_REQUEST_SEP} {i}\n")
            f.write(req if req.endswith("\n") else req + "\n")
    return path


def read_diff_trace(path: str) -> List[str]:
    """Load the request texts of a diff trace: a directory of ``*.diff``
    files (sorted name order = request order), or a single file —
    split on ``#! request`` separator lines when present, else one
    request. Raises ValueError on an empty source (path EXISTENCE is
    checked earlier, at parse time — ingest.service.ingest_errors)."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.diff")))
        if not files:
            raise ValueError(f"diff-trace directory {path} holds no "
                             f".diff files")
        out = []
        for fp in files:
            with open(fp) as f:
                out.append(f.read())
        return out
    with open(path) as f:
        text = f.read()
    if _REQUEST_SEP not in text:
        if not text.strip():
            raise ValueError(f"diff trace {path} is empty")
        return [text]
    requests: List[str] = []
    buf: List[str] = []
    for line in text.splitlines(keepends=True):
        if line.startswith(_REQUEST_SEP):
            if "".join(buf).strip():
                # content before the first separator is request 0 —
                # never silently dropped
                requests.append("".join(buf))
            buf = []
            continue
        buf.append(line)
    if "".join(buf).strip():
        requests.append("".join(buf))
    if not requests:
        raise ValueError(f"diff trace {path} holds no requests")
    return requests
