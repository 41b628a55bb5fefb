"""firacheck engine (counterpart of ``fira_tpu/analysis/engine.py``):
file walking, two-pass analysis, suppression folding.

Pass 1 collects the cross-file registries: the contract registry
(``*_errors`` validator fields + the fault-site tables —
rules_contracts.ContractRegistry) so the contract lints reason across
the whole scan, and the module-set call graph (callgraph.CallGraph over
every parsed tree) so the interprocedural rules resolve calls and
summaries across files. Pass 2 runs every rule per file, then folds in
the ``# firacheck: allow[...]`` waivers. The JAX package's third
registry, its donating factories, has no torch form (DONATION,
findings.NOT_CHECKED).
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional

from fira_tpu_torch.analysis import (astutil, rules_concurrency,
                                     rules_contracts, rules_determinism,
                                     rules_purity, rules_resources,
                                     rules_sync, rules_trace)
from fira_tpu_torch.analysis import suppress as suppress_lib
from fira_tpu_torch.analysis.callgraph import CallGraph
from fira_tpu_torch.analysis.findings import Finding, Severity


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                # `fixtures` dirs hold planted-hazard corpora (the analyzer's
                # own test bed) — hazards there are the point, so directory
                # walks skip them; naming a fixture file explicitly scans it
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d not in ("__pycache__", "fixtures"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
    return out


def _parse(path: str, source: str) -> Optional[ast.AST]:
    try:
        return ast.parse(source, filename=path)
    except SyntaxError:
        return None


def check_source(path: str, source: str, *,
                 contracts: Optional[
                     rules_contracts.ContractRegistry] = None,
                 suppress: bool = True,
                 tree: Optional[ast.AST] = None,
                 graph: Optional[CallGraph] = None,
                 ) -> List[Finding]:
    """Analyze one in-memory source; returns surviving findings.

    With ``suppress=False`` the raw (pre-waiver) findings come back —
    the fixture tests use this to pin that every rule fires. ``tree``
    lets check_paths reuse its registry-pass parse. ``contracts``: the
    cross-file contract registry; None builds one from this file alone
    (+ the real fault-site table — the single-file fixture path).
    ``graph``: the scan-wide call graph; None builds a single-file graph
    (same-module resolution still works — the fixture path).
    """
    tree = tree if tree is not None else _parse(path, source)
    if tree is None:
        # a syntax-broken file was analyzed by NO rule — that must gate,
        # or "clean scan" silently stops meaning anything for this file
        return [Finding(path, 1, "PARSE-ERROR", Severity.ERROR,
                        "file does not parse; none of its invariants "
                        "were checked")]
    if contracts is None:
        contracts = rules_contracts.ContractRegistry()
        rules_contracts.collect(path, tree, contracts)
        rules_contracts.finalize(contracts)
    if graph is None:
        graph = CallGraph.build({path: tree})
    parents = astutil.parent_map(tree)
    spans = astutil.hot_spans(tree, path, parents)
    findings: List[Finding] = []
    findings += rules_sync.check(path, tree, source, parents, spans)
    findings += rules_trace.check(path, tree, source, parents, spans)
    findings += rules_purity.check_prng(path, tree, source, parents, spans)
    findings += rules_purity.check_discarded_at(path, tree, source, parents,
                                                spans)
    findings += rules_purity.check_geometry(path, tree, source, parents,
                                            spans)
    findings += rules_concurrency.check(path, tree, source, parents, spans)
    findings += rules_contracts.check(path, tree, source, parents, spans,
                                      registry=contracts)
    findings += rules_resources.check(path, tree, source, parents, graph)
    findings += rules_determinism.check(path, tree, source, parents, graph)

    sups, bad = suppress_lib.parse_suppressions(path, source)
    if not suppress:
        return findings + bad
    kept, _waived = suppress_lib.apply_suppressions(findings, sups)
    kept += bad
    kept += suppress_lib.unused_suppressions(path, sups)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept


def check_paths(paths: Iterable[str], *, suppress: bool = True,
                ) -> List[Finding]:
    files = iter_py_files(paths)
    contracts = rules_contracts.ContractRegistry()
    sources = {}
    trees = {}
    findings: List[Finding] = []
    for path in files:
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                sources[path] = f.read()
        except OSError as e:
            # unanalyzed must gate, same contract as the unparseable case
            findings.append(Finding(
                path, 1, "PARSE-ERROR", Severity.ERROR,
                f"file could not be read ({e.__class__.__name__}); none "
                f"of its invariants were checked"))
            continue
        tree = _parse(path, sources[path])
        if tree is not None:
            trees[path] = tree  # reused in pass 2 — parse once per file
            rules_contracts.collect(path, tree, contracts)
    rules_contracts.finalize(contracts)
    graph = CallGraph.build(trees)  # interprocedural index (pass 1)
    for path in files:
        if path in sources:
            findings += check_source(path, sources[path],
                                     contracts=contracts, suppress=suppress,
                                     tree=trees.get(path), graph=graph)
    return findings


def has_errors(findings: Iterable[Finding]) -> bool:
    return any(f.severity is Severity.ERROR for f in findings)
