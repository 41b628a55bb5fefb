"""Forward dataflow walker shared by the v3 interprocedural rules
(counterpart of ``fira_tpu/analysis/dataflow.py``).

Two consumers with the same core need — "follow a value through the
statements of one function, in order" — and deliberately the same
simplifications:

- **Flow is syntactic**: statements are visited in source order,
  descending into compound bodies (if/for/while/with/try). Branches are
  NOT joined path-sensitively — a binding made in an ``if`` arm is
  visible after it (may-analysis: we want "can this happen on SOME
  path", which over-approximating branch joins gives us for free).
- **Loops run the transfer twice** so a fact produced at the bottom of
  a loop body reaches uses at the top (one extra pass reaches the
  fixpoint for the single-level facts tracked here — labels don't
  compose, they only spread).
- **Names only**: facts attach to local variable names and, read-only,
  to ``self.attr`` reads. Tuple targets spread the RHS fact to every
  element (over-approximate); subscript/attribute stores drop it
  (ownership transferred out of the local frame — the caller's rule
  decides what that means).

:class:`ForwardPass` is the engine; rules subclass nothing — they hand
it two callables (``source`` classifies an expression as introducing a
fact, ``on_stmt`` observes the post-transfer environment at every
statement) and read the results.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Iterator, List, Optional, Tuple

# bodies that nest statements; Try's handlers/orelse/finalbody handled
# explicitly in iter_statements
_BODY_FIELDS = ("body", "orelse", "finalbody")


def iter_statements(body: List[ast.stmt]) -> Iterator[ast.stmt]:
    """Pre-order statement walk in source order, descending into every
    compound-statement body (but NOT into nested function/class defs —
    those have their own frames)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in _BODY_FIELDS:
            sub = getattr(stmt, field, None)
            if sub:
                yield from iter_statements(sub)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from iter_statements(handler.body)


def name_loads(expr: ast.AST) -> List[str]:
    """Local names read anywhere inside ``expr`` (Load context), plus
    ``self.attr`` reads rendered as ``"self.attr"``."""
    out: List[str] = []
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            out.append(node.id)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            out.append(f"self.{node.attr}")
    return out


def target_names(target: ast.AST) -> List[str]:
    """Bindable names in an assignment target: plain names and
    ``self.attr`` stores; tuple/list targets flattened. Subscript and
    non-self attribute stores yield nothing (fact leaves the frame)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, ast.Attribute) \
            and isinstance(target.value, ast.Name) \
            and target.value.id == "self":
        return [f"self.{target.attr}"]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(target_names(el))
        return out
    if isinstance(target, ast.Starred):
        return target_names(target.value)
    return []


class ForwardPass:
    """Forward may-propagation of string-labelled facts over one
    function body.

    ``source(expr) -> Optional[str]`` names the fact an expression
    introduces (or None). Facts then spread through assignments,
    augmented assignments, for-targets, and with-items; any expression
    that READS a labelled name carries that label. ``on_stmt(stmt,
    env)`` fires for every statement on the FINAL pass with the
    environment as of just after that statement — rules do their sink
    checks there.
    """

    def __init__(self, source: Callable[[ast.AST], Optional[str]],
                 on_stmt: Optional[
                     Callable[[ast.stmt, Dict[str, str]], None]] = None
                 ) -> None:
        self._source = source
        self._on_stmt = on_stmt

    def expr_label(self, expr: Optional[ast.AST],
                   env: Dict[str, str]) -> Optional[str]:
        """The fact ``expr`` carries under ``env``: a direct source hit
        wins (most specific description), else the first labelled name
        it reads. Everything under a ``sorted(...)`` call is laundered —
        the facts tracked here are ORDER facts, and a sorted() wrapper
        re-establishes a deterministic order for its whole subtree."""
        if expr is None:
            return None
        covered = _sorted_covered(expr)
        for node in ast.walk(expr):
            if id(node) in covered:
                continue
            hit = self._source(node)
            if hit:
                return hit
        for node in ast.walk(expr):
            if id(node) in covered:
                continue
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in env:
                return env[node.id]
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" \
                    and f"self.{node.attr}" in env:
                return env[f"self.{node.attr}"]
        return None

    def run(self, body: List[ast.stmt],
            seed_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        """Two transfer passes (loop-carried facts), observer callbacks
        on the second. Returns the final environment."""
        env: Dict[str, str] = dict(seed_env or {})
        for final in (False, True):
            for stmt in iter_statements(body):
                self._transfer(stmt, env)
                if final and self._on_stmt is not None:
                    self._on_stmt(stmt, env)
        return env

    def _transfer(self, stmt: ast.stmt, env: Dict[str, str]) -> None:
        if isinstance(stmt, ast.Assign):
            label = self.expr_label(stmt.value, env)
            for t in stmt.targets:
                self._bind(t, label, env)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._bind(stmt.target, self.expr_label(stmt.value, env), env)
        elif isinstance(stmt, ast.AugAssign):
            # x += tainted taints x; x += clean keeps x's current label
            label = self.expr_label(stmt.value, env)
            if label:
                self._bind(stmt.target, label, env)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            # iterating a labelled iterable labels the loop variable
            self._bind(stmt.target, self.expr_label(stmt.iter, env), env,
                       keep=True)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    self._bind(item.optional_vars,
                               self.expr_label(item.context_expr, env), env)

    def _bind(self, target: ast.AST, label: Optional[str],
              env: Dict[str, str], keep: bool = False) -> None:
        for name in target_names(target):
            if label:
                env[name] = label
            elif not keep:
                env.pop(name, None)  # rebound clean -> fact killed


def _sorted_covered(expr: ast.AST) -> set:
    """ids of every node sitting under a ``sorted(...)`` call inside
    ``expr`` (including the call itself) — the laundered region."""
    covered: set = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "sorted":
            for inner in ast.walk(node):
                covered.add(id(inner))
    return covered


def local_bindings(fn_node: ast.AST) -> Dict[str, ast.AST]:
    """One-level local name -> RHS expression map for simple
    single-target assignments in a function body (last write wins).
    Used by registry rules (STATS-SCHEMA) to see through
    ``n = len(self.records); out["offered"] = n`` indirection."""
    out: Dict[str, ast.AST] = {}
    for stmt in iter_statements(fn_node.body):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            out[stmt.targets[0].id] = stmt.value
    return out
