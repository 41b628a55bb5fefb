"""Module-set call graph for the interprocedural rules (counterpart of
``fira_tpu/analysis/callgraph.py``; docs/ANALYSIS.md "v3:
interprocedural rules").

The v1/v2 rules are single-function pattern matchers; the two bug
families the v3 pack targets — an acquire whose release lives behind a
helper call (RES-LEAK) and a nondeterministic value that crosses a
function boundary before reaching a byte sink (DET-TAINT) — both
require following a value ACROSS calls. This module builds the index
that makes that possible without whole-program type inference:

- **def indexing**: every module-level function and every class method
  in the scanned tree set, keyed ``(path, qualname)`` where qualname is
  ``func`` or ``Class.method``.
- **call resolution** (:meth:`CallGraph.resolve`), deliberately scoped
  to the forms this repo's code actually uses and a static scan can get
  RIGHT: ``self.m(...)`` resolves within the caller's own class;
  ``f(...)`` resolves to a same-module function; ``mod.f(...)`` /
  ``alias.f(...)`` resolves through the file's imports when the target
  module is in the scan set. An unresolvable receiver (``obj.m(...)``
  on a value of unknown type) resolves to None — the rules treat those
  calls conservatively per-rule rather than guessing.
- **bounded-depth summaries**: :meth:`may_raise` answers "can a call to
  this function raise out of it?" by walking raise/assert statements,
  fault-injector ``check``/``corrupt`` sites (which raise BY CONTRACT
  when a chaos spec arms them), ``os.fsync`` (the one always-can-fail
  OS call the repo leans on), and resolved callees, to
  ``SUMMARY_DEPTH`` levels with cycle protection. The model is
  deliberately selective, not sound: treating EVERY call as
  may-raise would flag every two-statement acquire window in the tree
  and the signal would drown. What it claims, it can name — every
  may-raise verdict carries the concrete raising site.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

from fira_tpu_torch.analysis import astutil

# how many call levels a summary follows before giving up (a bounded
# walk keeps the scan O(files), and real escape chains here are short:
# the deepest in-tree chain is 3)
SUMMARY_DEPTH = 4

_INJECTOR_HINTS = ("fault", "injector")
# externals that raise as part of their everyday contract (OSError on a
# full/dying disk); kept tiny on purpose — see module docstring
_RAISING_CALLS = {"os.fsync"}

FuncKey = Tuple[str, str]  # (normalized path, qualname)


@dataclasses.dataclass
class FunctionInfo:
    """One indexed function/method definition."""

    path: str                  # display path (as scanned)
    norm: str                  # astutil.normalize_path(path)
    qualname: str              # "func" or "Class.method"
    cls: Optional[str]         # owning class name, None for module level
    node: ast.AST              # the FunctionDef/AsyncFunctionDef
    params: Tuple[str, ...]    # positional parameter names (incl. self)

    @property
    def key(self) -> FuncKey:
        return (self.norm, self.qualname)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


def _positional_params(node: ast.AST) -> Tuple[str, ...]:
    a = node.args
    return tuple(p.arg for p in (*a.posonlyargs, *a.args))


def _module_of(norm: str) -> str:
    """Dotted module guess for an absolute path: the path after the last
    ``fira_tpu_torch`` segment (``fira_tpu_torch.x.y``), else the bare
    stem — enough for suffix-matching module-qualified calls against the
    scan set."""
    rel = astutil.package_relative(norm)
    stem = (rel if rel is not None else os.path.basename(norm))
    stem = stem[:-3] if stem.endswith(".py") else stem
    return (f"{astutil.PACKAGE}." + stem.replace("/", ".")) \
        if rel is not None else stem.replace("/", ".")


def _file_imports(tree: ast.AST) -> Dict[str, str]:
    """alias -> dotted module for this file's module imports (both
    ``import a.b as m`` and ``from a import b``; ``from a import fn``
    also lands here and simply never suffix-matches a module)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


class CallGraph:
    """Def/use index + call resolution + bounded-depth raise summaries
    over one scan's parsed tree set."""

    def __init__(self) -> None:
        self.functions: Dict[FuncKey, FunctionInfo] = {}
        # module dotted name -> norm path (last definition wins; the
        # scan set has unique module paths so collisions don't matter)
        self._modules: Dict[str, str] = {}
        # per-file alias -> dotted module import map
        self._imports: Dict[str, Dict[str, str]] = {}
        # (norm, class or "") -> {method/function name -> qualname}
        self._scopes: Dict[Tuple[str, str], Dict[str, str]] = {}
        self._raise_memo: Dict[FuncKey, Optional[str]] = {}

    # --- construction ---

    @classmethod
    def build(cls, trees: Dict[str, ast.AST]) -> "CallGraph":
        g = cls()
        for path, tree in trees.items():
            g.add_file(path, tree)
        return g

    def add_file(self, path: str, tree: ast.AST) -> None:
        norm = astutil.normalize_path(path)
        self._modules[_module_of(norm)] = norm
        self._imports[norm] = _file_imports(tree)
        for node in tree.body if hasattr(tree, "body") else []:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index(path, norm, None, node)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._index(path, norm, node.name, sub)

    def _index(self, path: str, norm: str, cls_name: Optional[str],
               node: ast.AST) -> None:
        qual = f"{cls_name}.{node.name}" if cls_name else node.name
        info = FunctionInfo(path=path, norm=norm, qualname=qual,
                            cls=cls_name, node=node,
                            params=_positional_params(node))
        self.functions[info.key] = info
        self._scopes.setdefault((norm, cls_name or ""), {})[node.name] = qual

    # --- resolution ---

    def resolve(self, path: str, caller_cls: Optional[str],
                call: ast.Call) -> Optional[FunctionInfo]:
        """The FunctionInfo a call resolves to, or None (unknown
        receiver / not in the scan set). See the module docstring for
        the supported forms."""
        norm = astutil.normalize_path(path)
        func = call.func
        # self.m(...) -> method in the caller's class
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "self" and caller_cls:
            qual = self._scopes.get((norm, caller_cls), {}).get(func.attr)
            return self.functions.get((norm, qual)) if qual else None
        # f(...) -> same-module function
        if isinstance(func, ast.Name):
            qual = self._scopes.get((norm, ""), {}).get(func.id)
            return self.functions.get((norm, qual)) if qual else None
        # mod.f(...) / alias.f(...) through the file's imports
        if isinstance(func, ast.Attribute):
            recv = astutil.dotted(func.value)
            if recv is None:
                return None
            mod = self._imports.get(norm, {}).get(recv.split(".")[0])
            if mod is not None:
                target = self._module_path(mod)
                if target is not None:
                    qual = self._scopes.get((target, ""), {}).get(func.attr)
                    if qual:
                        return self.functions.get((target, qual))
            return self._affinity_resolve(norm, recv, func.attr)
        return None

    def _affinity_resolve(self, norm: str, recv: str,
                          attr: str) -> Optional[FunctionInfo]:
        """Receiver-name affinity fallback for unknown-typed receivers:
        when exactly ONE same-file class whose name contains (or is
        contained by) the receiver's last segment defines ``attr``,
        resolve to that method — ``stats.summary()`` next to a single
        ``ServeStats`` class is unambiguous in practice. Anything less
        constrained stays unresolved (no guessing)."""
        seg = (astutil.last_segment(recv) or "").lstrip("_").lower()
        if not seg:
            return None
        hits: List[FuncKey] = []
        for (n, c), scope in self._scopes.items():
            if n != norm or not c or attr not in scope:
                continue
            cl = c.lower()
            if seg in cl or cl in seg:
                hits.append((n, scope[attr]))
        return self.functions.get(hits[0]) if len(hits) == 1 else None

    def _module_path(self, dotted_mod: str) -> Optional[str]:
        if dotted_mod in self._modules:
            return self._modules[dotted_mod]
        # suffix match: `from fira_tpu_torch.robust import recovery`
        # imports module "fira_tpu_torch.robust.recovery"
        for mod, norm in self._modules.items():
            if mod == dotted_mod or mod.endswith("." + dotted_mod):
                return norm
        return None

    # --- bounded-depth summaries ---

    def may_raise(self, info: FunctionInfo,
                  depth: int = SUMMARY_DEPTH) -> Optional[str]:
        """A human-readable description of a site inside ``info`` (or a
        callee, to ``depth`` levels) that can raise out of it, or None.
        Memoized; cycles read as in-progress -> None (a recursive chain
        adds no NEW raising site beyond what its body already shows)."""
        key = info.key
        if key in self._raise_memo:
            return self._raise_memo[key]
        self._raise_memo[key] = None  # cycle guard
        verdict = self._may_raise_walk(info, depth)
        self._raise_memo[key] = verdict
        return verdict

    def _may_raise_walk(self, info: FunctionInfo,
                        depth: int) -> Optional[str]:
        where = os.path.basename(info.path)
        for node in ast.walk(info.node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not info.node:
                continue  # nested defs don't run at call time
            if isinstance(node, ast.Raise):
                return f"raise at {where}:{node.lineno}"
            if isinstance(node, ast.Assert):
                return f"assert at {where}:{node.lineno}"
            if isinstance(node, ast.Call):
                desc = self.call_may_raise(info.path, info.cls, node,
                                           depth=depth)
                if desc:
                    return desc
        return None

    def call_may_raise(self, path: str, caller_cls: Optional[str],
                       call: ast.Call,
                       depth: int = SUMMARY_DEPTH) -> Optional[str]:
        """May THIS call expression raise: injector check/corrupt sites
        (raise by contract under an armed chaos spec), the known-raising
        externals table, or a resolved callee whose own summary says so."""
        where = os.path.basename(path)
        name = astutil.call_name(call)
        if name in _RAISING_CALLS:
            return f"{name} at {where}:{call.lineno}"
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in ("check", "corrupt"):
            recv = astutil.dotted(call.func.value)
            seg = (astutil.last_segment(recv) or "").lower()
            if any(h in seg for h in _INJECTOR_HINTS):
                return (f"fault-injector .{call.func.attr}() at "
                        f"{where}:{call.lineno} (raises when armed)")
        if depth <= 0:
            return None
        target = self.resolve(path, caller_cls, call)
        if target is not None:
            inner = self.may_raise(target, depth - 1)
            if inner:
                return (f"{target.qualname}() at {where}:{call.lineno} "
                        f"-> {inner}")
        return None
