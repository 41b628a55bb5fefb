"""RES-LEAK: interprocedural resource-lifecycle analysis (firacheck v3;
counterpart of ``fira_tpu/analysis/rules_resources.py``,
framework-neutral: only the driver-module paths are the port's).

The bug class (found by hand in the JAX package's reviews): a resource is
acquired, a statement between the acquire and the release can raise,
and no ``finally``/``with`` covers the release — the exception strands
the resource. Intra-procedural linting cannot see the worst instances
because the raising statement is often an innocent-looking helper call
(``self.append(...)`` whose body fsyncs; a prefill helper with an
``assert``); v3 resolves those calls through the module-set
:mod:`callgraph` and uses its bounded-depth may-raise summaries.

Tracked resources — the repo's REAL lifecycles, nothing speculative:

==============================  =======================================
acquire                         release / handoff
==============================  =======================================
``x = *._acquire_blocks(n)``    ``*._release_blocks(x)``
``t = Thread(...); t.start()``  ``t.join(...)``
``p = ThreadPoolExecutor(..)``  ``p.shutdown(...)`` or ``with``
``f = open(...)``               ``f.close()`` or ``with``
``ev = threading.Event()``      ``ev.set()`` (follower wakeup handoff)
==============================  =======================================

Window semantics (one window per acquired binding, statements walked in
source order):

- **close** on the release call, on ``join``/``shutdown``/``close``.
- **ownership transfer** closes the window without complaint: storing
  the value into ``self.*`` or any subscript, returning/yielding it, or
  passing it as an argument to any other call (the callee or container
  owns it now — each frame is responsible for its own window).
- **``__init__`` is special**: ``self.attr = <resource>`` does NOT
  transfer — until ``__init__`` returns, no caller holds the object, so
  an exception after the store strands the resource with nobody able to
  close it (the Journal-fsync class of bug). The window is renamed to
  the attribute and runs to the end of ``__init__``; reaching the end
  closes it silently (the constructed object now owns it).
- **fire** when a statement inside an open window may raise — a
  ``raise``/``assert``, a known-raising call, or a call whose
  :meth:`~fira_tpu_torch.analysis.callgraph.CallGraph.may_raise` summary says
  so — and neither the acquire nor the raising statement sits under a
  ``try`` whose ``finally`` (or an except handler) performs the
  release. The finding lands at the ACQUIRE line and names the
  escaping path.
- a window still open at the end of the function (never released,
  never handed off) fires as a straight leak — except ``Event``
  windows, whose release legitimately belongs to another component.

Scope: driver modules only (``astutil.is_driver_module``), same arming
as the v2 concurrency rules. Acquires not bound to a name are not
tracked (no binding, no window — document-level honesty over guessing).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from fira_tpu_torch.analysis import astutil
from fira_tpu_torch.analysis.callgraph import CallGraph
from fira_tpu_torch.analysis.dataflow import iter_statements, name_loads, \
    target_names
from fira_tpu_torch.analysis.findings import Finding, Severity

_BLOCK_ACQUIRES = {"_acquire_blocks", "acquire_blocks"}
_BLOCK_RELEASES = {"_release_blocks", "release_blocks"}
_POOL_CTORS = {"ThreadPoolExecutor", "ProcessPoolExecutor"}

# kind -> receiver-method that closes its window
_METHOD_RELEASES = {
    "thread": "join",
    "pool": "shutdown",
    "file": "close",
    "event": "set",
}
_SIMPLE_STMTS = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr,
                 ast.Return, ast.Raise, ast.Assert, ast.Delete)


@dataclasses.dataclass
class _Window:
    kind: str            # blocks | thread | pool | file | event
    what: str            # human description of the acquire
    line: int            # acquire line (where the finding lands)
    acquire_stmt: ast.stmt
    fired: bool = False


def _acquire_of(call: ast.Call) -> Optional[Tuple[str, str]]:
    """(kind, description) when ``call`` is a tracked acquire."""
    seg = astutil.last_segment(astutil.call_name(call) or "")
    if seg in _BLOCK_ACQUIRES:
        return "blocks", f"KV block grant from {seg}()"
    if seg in _POOL_CTORS:
        return "pool", f"{seg} worker pool"
    if seg == "open" and isinstance(call.func, ast.Name):
        return "file", "open() file handle"
    if seg == "Event":
        return "event", "threading.Event follower wakeup"
    return None


def _pending_thread(call: ast.Call) -> bool:
    return astutil.last_segment(astutil.call_name(call) or "") == "Thread"


def _receiver(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return astutil.dotted(call.func.value)
    return None


def _arg_names(call: ast.Call) -> Set[str]:
    out: Set[str] = set()
    for a in list(call.args) + [k.value for k in call.keywords]:
        out.update(name_loads(a))
    return out


def _stmt_calls(stmt: ast.stmt) -> List[ast.Call]:
    """Calls evaluated BY this statement itself: a simple statement's
    whole subtree; only the header expressions of compound statements
    (their bodies are walked as their own statements)."""
    if isinstance(stmt, _SIMPLE_STMTS):
        roots: List[ast.AST] = [stmt]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.iter]
    elif isinstance(stmt, (ast.While, ast.If)):
        roots = [stmt.test]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = [i.context_expr for i in stmt.items]
    else:
        return []
    out: List[ast.Call] = []
    for root in roots:
        for node in ast.walk(root):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                break
            if isinstance(node, ast.Call):
                out.append(node)
    return out


def _stmt_may_raise(stmt: ast.stmt, graph: CallGraph, path: str,
                    cls: Optional[str]) -> Optional[str]:
    if isinstance(stmt, ast.Raise):
        return f"raise at line {stmt.lineno}"
    if isinstance(stmt, ast.Assert):
        return f"assert at line {stmt.lineno}"
    for call in _stmt_calls(stmt):
        desc = graph.call_may_raise(path, cls, call)
        if desc:
            return desc
    return None


def _releases_in(nodes: List[ast.stmt], win: _Window) -> bool:
    """Does any statement in ``nodes`` perform a release for ``win``'s
    kind? (Used for try/finally + except-handler protection checks —
    name-insensitive on purpose: a finally that releases the KIND is
    accepted as covering the window.)"""
    for stmt in nodes:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            seg = astutil.last_segment(astutil.call_name(node) or "")
            if win.kind == "blocks" and seg in _BLOCK_RELEASES:
                return True
            if seg == _METHOD_RELEASES.get(win.kind):
                return True
    return False


def _protected(stmt: ast.stmt, win: _Window, parents) -> bool:
    """Is a raise inside ``stmt`` covered: some enclosing ``try`` (of
    the raising statement or of the acquire) releases the window's kind
    in its ``finally`` or an except handler."""
    for anchor in (stmt, win.acquire_stmt):
        for anc in astutil.ancestors(anchor, parents):
            if isinstance(anc, ast.Try):
                if _releases_in(anc.finalbody, win):
                    return True
                for h in anc.handlers:
                    if _releases_in(h.body, win):
                        return True
    return False


class _FunctionScan:
    def __init__(self, path: str, cls: Optional[str], fn: ast.AST,
                 graph: CallGraph, parents) -> None:
        self.path = path
        self.cls = cls
        self.fn = fn
        self.graph = graph
        self.parents = parents
        self.in_init = fn.name == "__init__"
        self.windows: Dict[str, _Window] = {}
        self.pending_threads: Set[str] = set()
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        stmts = list(iter_statements(self.fn.body))
        for stmt in stmts:
            self._close_releases(stmt)
            self._check_raises(stmt)
            self._close_transfers(stmt)
            self._open_acquires(stmt)
        for name, win in self.windows.items():
            if win.fired or win.kind == "event":
                continue
            if self.in_init and name.startswith("self."):
                continue  # constructed object owns it now
            self.findings.append(Finding(
                self.path, win.line, "RES-LEAK", Severity.ERROR,
                f"{win.what} bound to '{name}' is never released or "
                f"handed off on the fall-through path",
            ))
        return self.findings

    # -- stages --

    def _close_releases(self, stmt: ast.stmt) -> None:
        for call in _stmt_calls(stmt):
            seg = astutil.last_segment(astutil.call_name(call) or "")
            recv = _receiver(call)
            if seg in _BLOCK_RELEASES:
                args = _arg_names(call)
                for name in [n for n, w in self.windows.items()
                             if w.kind == "blocks"
                             and (n in args or not args)]:
                    del self.windows[name]
                continue
            if recv in self.windows \
                    and seg == _METHOD_RELEASES.get(self.windows[recv].kind):
                del self.windows[recv]

    def _check_raises(self, stmt: ast.stmt) -> None:
        if not self.windows:
            return
        desc = _stmt_may_raise(stmt, self.graph, self.path, self.cls)
        if not desc:
            return
        for name, win in self.windows.items():
            if win.fired or stmt is win.acquire_stmt:
                continue
            if _protected(stmt, win, self.parents):
                continue
            win.fired = True
            self.findings.append(Finding(
                self.path, win.line, "RES-LEAK", Severity.ERROR,
                f"{win.what} can leak: {desc} can raise before the "
                f"release of '{name}' with no finally/with covering it",
            ))

    def _close_transfers(self, stmt: ast.stmt) -> None:
        if not self.windows:
            return
        # store into self.* or any subscript; return/yield
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            reads = name_loads(stmt.value) if stmt.value is not None else []
            for name in [n for n in list(self.windows) if n in reads]:
                for t in targets:
                    names = target_names(t)
                    self_store = any(x.startswith("self.") for x in names)
                    if self_store and self.in_init:
                        # rename: the half-built object holds it now, but
                        # no caller can close it until __init__ returns
                        for x in names:
                            if x.startswith("self."):
                                self.windows[x] = self.windows.pop(name)
                                break
                    elif self_store or isinstance(t, ast.Subscript):
                        self.windows.pop(name, None)
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            for name in name_loads(stmt.value):
                self.windows.pop(name, None)
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     (ast.Yield,
                                                      ast.YieldFrom)):
            val = stmt.value.value
            for name in (name_loads(val) if val is not None else []):
                self.windows.pop(name, None)
        # handoff: the value passed as an argument to any call
        for call in _stmt_calls(stmt):
            seg = astutil.last_segment(astutil.call_name(call) or "")
            if seg in _BLOCK_RELEASES:
                continue  # handled as a release
            for name in _arg_names(call) & set(self.windows):
                del self.windows[name]

    def _open_acquires(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return  # context manager = protected by construction
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                or stmt.value is None or not isinstance(stmt.value, ast.Call):
            # `t.start()` promotes a pending thread binding to a window
            if isinstance(stmt, ast.Expr) \
                    and isinstance(stmt.value, ast.Call):
                call = stmt.value
                recv = _receiver(call)
                if recv in self.pending_threads and isinstance(
                        call.func, ast.Attribute) and call.func.attr == "start":
                    self.windows[recv] = _Window(
                        "thread", "started Thread", stmt.lineno, stmt)
            return
        call = stmt.value
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        names = [n for t in targets for n in target_names(t)]
        if not names:
            return
        if _pending_thread(call):
            self.pending_threads.update(names)
            return
        hit = _acquire_of(call)
        if hit is None:
            return
        kind, what = hit
        self.windows[names[0]] = _Window(kind, what, stmt.lineno, stmt)


def check(path: str, tree: ast.AST, source: str, parents,
          graph: CallGraph) -> List[Finding]:
    if not astutil.is_driver_module(path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cls = None
        for anc in astutil.ancestors(node, parents):
            if isinstance(anc, ast.ClassDef):
                cls = anc.name
                break
        findings.extend(_FunctionScan(path, cls, node, graph, parents).run())
    return findings
