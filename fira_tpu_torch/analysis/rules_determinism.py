"""DET-TAINT: byte-determinism taint analysis (firacheck v3; counterpart
of ``fira_tpu/analysis/rules_determinism.py``, framework-neutral: only
the driver-module paths are the port's).

The serving contract says output bytes are a pure function of the
request stream (docs/SERVING.md). FLOAT-ORDER (v2) catches ONE local
shape of the violation — a float ``+=`` inside an unordered loop. The
general bug is a FLOW: a value whose identity depends on
nondeterministic ORDER reaches a sink that commits bytes, and the
source and sink are frequently in different statements or different
functions. This rule runs the :class:`~fira_tpu_torch.analysis.dataflow.
ForwardPass` taint engine over every function in a driver module, with
call-graph summaries carrying taint across function boundaries.

**Sources** (order-nondeterminism enters a value):

- iteration over ``.values()`` / ``.items()`` / ``.keys()`` / a set —
  settle/insertion order (same detector family as FLOAT-ORDER, but
  producing a taint instead of requiring the ``+=`` right there);
- ``os.listdir(...)`` — the OS returns directory entries unsorted;
- ``as_completed(...)`` — thread completion order;
- ``queue.get()``-drained batches are NOT flagged (the repo's queues
  are single-producer FIFO by design — see docs/ANALYSIS.md);
- a call to a scanned function whose RETURN value is tainted
  (bounded-depth, memoized — the interprocedural half).

``sorted(...)`` launders its whole subtree: every taint here is an
order fact, and sorted() re-establishes a deterministic order.

**Sinks** (bytes get committed):

- ``<writer>.add(...)`` — OrderedStreamWriter output lines;
- ``json.dump/dumps(...)`` — serve_metrics.json / journal payloads;
- ``<journal>.append(...)`` — the recovery journal;
- ``write_metrics_atomic(...)``;
- keyed digests — ``times_digest(...)``, ``hashlib`` constructions,
  ``<digest>.update(...)``;
- BLEU accumulation — a call whose name mentions ``bleu``;
- passing a tainted value to a scanned function that forwards that
  parameter into one of the above (the caller-side interprocedural
  check; fires at the call, naming the callee's sink).

Scope: driver modules only. Severity ERROR — a hit is a reproducible
byte-contract break, not a style nit.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from fira_tpu_torch.analysis import astutil
from fira_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo, FuncKey
from fira_tpu_torch.analysis.dataflow import ForwardPass
from fira_tpu_torch.analysis.findings import Finding, Severity

_DIGEST_HINTS = ("digest", "hash", "blake", "sha", "md5")
_WRITER_HINTS = ("writer", "stream")
_JOURNAL_HINTS = ("journal",)
_SUMMARY_DEPTH = 3
_PARAM_MARK = "\x00param:"  # internal seed label for param->sink summaries


def _unordered_source(node: ast.AST) -> Optional[str]:
    """Settle-order iteration sources (the FLOAT-ORDER detector family,
    yielding a description instead of a finding). Dict-view iteration
    counts only on ``self.*`` receivers: shared instance state is what
    threads populate in settle order — a local dict built from literal
    keys in the same frame iterates deterministically."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("values", "items", "keys") \
            and not node.args:
        owner = astutil.dotted(node.func.value) or ""
        if owner.startswith("self."):
            return f"{owner}.{node.func.attr}() settle order"
        return None
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return f"{node.func.id}() iteration order"
    if isinstance(node, ast.Set):
        return "set-literal iteration order"
    return None


def _sink_of(call: ast.Call) -> Optional[str]:
    """Byte-sink description for a call, or None."""
    name = astutil.call_name(call) or ""
    seg = astutil.last_segment(name) or ""
    if seg in ("dump", "dumps") and name.startswith("json"):
        return f"json.{seg}() serialization"
    if seg == "write_metrics_atomic":
        return "write_metrics_atomic() metrics bytes"
    if seg == "times_digest" or seg in ("blake2b", "blake2s", "sha256",
                                        "sha1", "md5"):
        return f"{seg}() keyed digest"
    if "bleu" in seg.lower():
        return f"{seg}() BLEU accumulation"
    if isinstance(call.func, ast.Attribute):
        recv = (astutil.last_segment(astutil.dotted(call.func.value) or "")
                or "").lower()
        if call.func.attr == "add" and any(h in recv for h in _WRITER_HINTS):
            return "OrderedStreamWriter.add() output line"
        if call.func.attr == "append" \
                and any(h in recv for h in _JOURNAL_HINTS):
            return "journal.append() record"
        if call.func.attr == "update" \
                and any(h in recv for h in _DIGEST_HINTS):
            return f"{recv}.update() digest"
    return None


class _TaintScan:
    """One file's DET-TAINT pass, with memoized cross-function
    summaries resolved through the scan-wide call graph."""

    def __init__(self, graph: CallGraph) -> None:
        self.graph = graph
        self._returns_memo: Dict[FuncKey, Optional[str]] = {}
        self._param_sink_memo: Dict[FuncKey, Dict[str, str]] = {}

    # -- summaries --

    def returns_taint(self, info: FunctionInfo,
                      depth: int = _SUMMARY_DEPTH) -> Optional[str]:
        """Does a call to ``info`` return an order-tainted value?"""
        if info.key in self._returns_memo:
            return self._returns_memo[info.key]
        self._returns_memo[info.key] = None  # cycle guard
        found: List[str] = []

        def on_stmt(stmt: ast.stmt, env: Dict[str, str]) -> None:
            if isinstance(stmt, ast.Return) and stmt.value is not None \
                    and not found:
                label = walker.expr_label(stmt.value, env)
                if label:
                    found.append(label)

        walker = ForwardPass(self._source_fn(info, depth - 1), on_stmt)
        walker.run(info.node.body)
        verdict = found[0] if found else None
        self._returns_memo[info.key] = verdict
        return verdict

    def param_sinks(self, info: FunctionInfo) -> Dict[str, str]:
        """param name -> sink description, for parameters ``info``
        forwards into a byte sink (one summary level)."""
        if info.key in self._param_sink_memo:
            return self._param_sink_memo[info.key]
        self._param_sink_memo[info.key] = {}  # cycle guard
        params = [p for p in info.params if p != "self"]
        seed = {p: f"{_PARAM_MARK}{p}" for p in params}
        hits: Dict[str, str] = {}

        def on_stmt(stmt: ast.stmt, env: Dict[str, str]) -> None:
            for call in [n for n in ast.walk(stmt)
                         if isinstance(n, ast.Call)]:
                sink = _sink_of(call)
                if not sink:
                    continue
                for a in list(call.args) + [k.value for k in call.keywords]:
                    label = walker.expr_label(a, env)
                    if label and label.startswith(_PARAM_MARK):
                        hits.setdefault(label[len(_PARAM_MARK):], sink)

        walker = ForwardPass(lambda node: None, on_stmt)
        walker.run(info.node.body, seed_env=seed)
        self._param_sink_memo[info.key] = hits
        return hits

    # -- per-function scan --

    def _source_fn(self, info: FunctionInfo, depth: int):
        def source(node: ast.AST) -> Optional[str]:
            hit = _unordered_source(node)
            if hit:
                return hit
            if not isinstance(node, ast.Call):
                return None
            seg = astutil.last_segment(astutil.call_name(node) or "")
            if seg == "listdir":
                return "os.listdir() scan order"
            if seg == "as_completed":
                return "as_completed() thread-completion order"
            if depth > 0:
                target = self.graph.resolve(info.path, info.cls, node)
                if target is not None and target.key != info.key:
                    inner = self.returns_taint(target, depth)
                    if inner:
                        return f"{target.qualname}() -> {inner}"
            return None
        return source

    def scan_function(self, info: FunctionInfo) -> List[Finding]:
        findings: List[Finding] = []
        seen: Set[Tuple[int, str]] = set()

        def on_stmt(stmt: ast.stmt, env: Dict[str, str]) -> None:
            for call in [n for n in ast.walk(stmt)
                         if isinstance(n, ast.Call)]:
                args = list(call.args) + [k.value for k in call.keywords]
                sink = _sink_of(call)
                if sink:
                    for a in args:
                        label = walker.expr_label(a, env)
                        if label:
                            self._emit(findings, seen, info.path,
                                       call.lineno, label, sink)
                            break
                    continue
                target = self.graph.resolve(info.path, info.cls, call)
                if target is None or target.key == info.key:
                    continue
                forwarded = self.param_sinks(target)
                if not forwarded:
                    continue
                params = [p for p in target.params if p != "self"]
                for i, a in enumerate(call.args):
                    if i >= len(params) or params[i] not in forwarded:
                        continue
                    label = walker.expr_label(a, env)
                    if label:
                        self._emit(
                            findings, seen, info.path, call.lineno, label,
                            f"{forwarded[params[i]]} inside "
                            f"{target.qualname}()")

        walker = ForwardPass(self._source_fn(info, _SUMMARY_DEPTH), on_stmt)
        walker.run(info.node.body)
        return findings

    @staticmethod
    def _emit(findings: List[Finding], seen: Set[Tuple[int, str]],
              path: str, line: int, label: str, sink: str) -> None:
        key = (line, sink)
        if key in seen:
            return
        seen.add(key)
        findings.append(Finding(
            path, line, "DET-TAINT", Severity.ERROR,
            f"nondeterministic value ({label}) flows into byte sink: "
            f"{sink}",
        ))


def check(path: str, tree: ast.AST, source: str, parents,
          graph: CallGraph) -> List[Finding]:
    if not astutil.is_driver_module(path):
        return []
    scan = _TaintScan(graph)
    norm = astutil.normalize_path(path)
    findings: List[Finding] = []
    for info in graph.functions.values():
        if info.norm == norm:
            findings.extend(scan.scan_function(info))
    return findings
