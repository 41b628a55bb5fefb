"""Concurrency-race rules (counterpart of
``fira_tpu/analysis/rules_concurrency.py``): the serving stack's race
bugs, which reviews of the JAX package caught by hand, mechanized
(docs/ANALYSIS.md "v2: concurrency rules"). These hazards do not depend on the framework; only
the module paths and the names of the dispatch/readback boundaries are
the port's.

The serving stack is multi-threaded three ways: feeder worker threads
assemble payloads, watchdog worker threads run dispatches that may be
ABANDONED mid-flight (robust/watchdog.py), and the scheduler thread owns
the round loop. Every rule here encodes a discipline this repo already
fixed a real bug against:

- SHARED-MUT — a ``self._x`` attribute written under ``with self._lock``
  in some places but bare in others (the FaultInjector.fired class), or
  written bare from both a thread-entry method and a non-entry method
  (the MemoTally cross-count class).
- RETIRED-RECHECK — shared scheduling/guard state mutated after a
  dispatch/readback boundary without re-checking ``self.retired``: the
  abandoned-watchdog-thread class, fixed three separate times.
- SCHED-BLOCK — a blocking primitive (``time.sleep``, ``.wait()`` /
  ``.result()`` / ``.join()`` without a timeout, ``os.fsync``) inside a
  hot region of a driver module: the scheduler/worker hot paths must
  never block uncancellably (the busy-spin/pause class).
- WALL-CLOCK — ``time.time``/``perf_counter``/``monotonic`` in a module
  that schedules under the virtual clock, outside the ``*Clock`` classes:
  wall time leaking into virtual-clock replay broke determinism and a
  dimensionless stall fraction.
- FLOAT-ORDER — float ``+=`` accumulation iterating an unordered /
  settle-ordered container in a threaded driver module: float addition
  does not reassociate, so the aggregate depends on thread interleaving
  in the last ulp (the BLEU-sum bug; fixed by summing in split order).

Scoping: all five run only in designated driver modules
(astutil._DRIVER_FILES) — plus, for WALL-CLOCK, only the modules that
actually schedule under ``serve.server.make_clock`` — so host-only text
cooking and checkpoint I/O never pay waiver noise.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from fira_tpu_torch.analysis import astutil
from fira_tpu_torch.analysis.findings import Finding, Severity

# modules whose scheduler runs under serve.server.make_clock (wall OR
# virtual): a raw wall-clock read outside the *Clock classes here either
# breaks virtual-replay determinism or divides a wall numerator by a
# virtual denominator. ingest stage stamps (ingest/service.py) are
# deliberately NOT in scope: they are worker-side wall metering,
# documented as schedule-dependent.
_VIRTUAL_CLOCK_FILES = (
    "serve/server.py",
    "parallel/fleet.py",
    "decode/engine.py",
    "robust/recovery.py",
)

# dispatch/readback boundaries a watchdog expiry can abandon a thread
# inside: device readbacks and waits by name, and the engine's step
# programs by self-attribute idiom (decode/engine.py)
_BOUNDARY_CALLS = {"torch.cuda.synchronize"}
_BOUNDARY_SELF_ATTRS = {"_prefill", "_step", "_insert", "_read_rows",
                        "_spec_round"}
_BOUNDARY_ATTRS = {"cpu", "synchronize"}

# container-mutating method names: a call self._x.append(...) mutates _x
_MUTATING_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "add", "discard", "move_to_end",
}
# shared-state method calls the abandoned-thread discipline names
# explicitly: touching the (process-shared) compile guard from an
# abandoned thread races the live loop that owns it
_GUARD_SELF_CALLS = {"_guard_step"}

_BLOCKING_CALLS = {"time.sleep": "time.sleep",
                   "os.fsync": "os.fsync",
                   "sleep": "time.sleep",
                   "fsync": "os.fsync"}
_BLOCKING_ATTRS = {"wait", "result", "join"}  # flagged only with NO timeout
# lifecycle functions where blocking is the contract, not a stall:
# shutdown joins its threads, __exit__ drains, close flushes
_LIFECYCLE_FUNCS = {"close", "shutdown", "__exit__", "__del__", "stop"}

# bare names cover the `from time import time/perf_counter/monotonic`
# idiom; a bare-Name call cannot collide with `clock.time()`-style
# attribute calls, which resolve to a dotted name
_WALL_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
               "time", "perf_counter", "monotonic"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for ``self.x``; None otherwise."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _mutated_attrs(node: ast.AST) -> List[str]:
    """EVERY self-attribute a statement-level node mutates:
    ``self.x = v`` / ``self.x += v`` / ``self.x[k] = v`` /
    ``self.a, self.b = ...`` (all tuple elements, not just the first) /
    ``self.x.append(v)``-style container calls."""
    out: List[str] = []
    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for e in elts:
                a = _self_attr(e)
                if a is None and isinstance(e, ast.Subscript):
                    a = _self_attr(e.value)
                if a:
                    out.append(a)
    elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
        call = node.value
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _MUTATING_METHODS:
            recv = call.func.value
            a = _self_attr(recv)
            if a is None and isinstance(recv, ast.Subscript):
                a = _self_attr(recv.value)
            if a:
                out.append(a)
    return out


def _lockish_name(expr: ast.AST) -> Optional[str]:
    """The name of a lock-like context expression (``self._lock``,
    ``self._cond``, a bare ``lock`` variable), else None."""
    name = None
    a = _self_attr(expr)
    if a is not None:
        name = a
    elif isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Call):
        return _lockish_name(expr.func.value) \
            if isinstance(expr.func, ast.Attribute) else None
    if name is None:
        return None
    low = name.lower()
    if "lock" in low or "cond" in low or "mutex" in low:
        return name
    return None


def _under_lock(node: ast.AST, parents, stop: ast.AST) -> bool:
    for a in astutil.ancestors(node, parents):
        if a is stop:
            return False
        if isinstance(a, ast.With):
            for item in a.items:
                if _lockish_name(item.context_expr):
                    return True
    return False


def _methods(cls: ast.ClassDef) -> List[ast.AST]:
    return [n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _thread_entry_methods(cls: ast.ClassDef) -> Set[str]:
    """Methods of this class handed to a thread: ``Thread(target=self.m)``
    or ``pool.submit(self.m, ...)`` anywhere in the class body."""
    entries: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        callee = astutil.call_name(node)
        if callee and astutil.last_segment(callee) == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    m = _self_attr(kw.value)
                    if m:
                        entries.add(m)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "submit" and node.args:
            m = _self_attr(node.args[0])
            if m:
                entries.add(m)
    return entries


def _reachable_methods(cls: ast.ClassDef, roots: Set[str]) -> Set[str]:
    """roots + methods they transitively call via ``self.m(...)``."""
    calls: Dict[str, Set[str]] = {}
    for m in _methods(cls):
        out: Set[str] = set()
        for node in ast.walk(m):
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee:
                    out.add(callee)
        calls[m.name] = out
    reach = set(roots)
    frontier = list(roots)
    while frontier:
        m = frontier.pop()
        for callee in calls.get(m, ()):
            if callee in calls and callee not in reach:
                reach.add(callee)
                frontier.append(callee)
    return reach


@dataclasses.dataclass
class _Write:
    attr: str
    method: str
    line: int
    locked: bool


def check_shared_mut(path: str, tree: ast.AST, source: str, parents,
                     spans) -> List[Finding]:
    """SHARED-MUT: per-class write-site registry + lock inference."""
    if not astutil.is_driver_module(path):
        return []
    findings: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        writes: List[_Write] = []
        for m in _methods(cls):
            if m.name == "__init__":
                continue  # construction precedes sharing: no lock needed
            for node in ast.walk(m):
                for attr in _mutated_attrs(node):
                    writes.append(_Write(attr, m.name, node.lineno,
                                         _under_lock(node, parents, m)))
        by_attr: Dict[str, List[_Write]] = {}
        for w in writes:
            by_attr.setdefault(w.attr, []).append(w)
        entries = _thread_entry_methods(cls)
        reach = _reachable_methods(cls, entries) if entries else set()
        for attr, sites in sorted(by_attr.items()):
            locked = [w for w in sites if w.locked]
            bare = [w for w in sites if not w.locked]
            if locked and bare:
                lw = locked[0]
                for w in bare:
                    findings.append(Finding(
                        path, w.line, "SHARED-MUT", Severity.ERROR,
                        f"`self.{attr}` is written under a lock in "
                        f"{cls.name}.{lw.method} (line {lw.line}) but bare "
                        f"here in {cls.name}.{w.method}: the lock protects "
                        f"nothing unless every write site holds it"))
            elif bare and reach:
                worker = [w for w in bare if w.method in reach]
                owner = [w for w in bare if w.method not in reach]
                if worker and owner:
                    ow = owner[0]
                    for w in worker:
                        findings.append(Finding(
                            path, w.line, "SHARED-MUT", Severity.ERROR,
                            f"`self.{attr}` is mutated on a thread-entry "
                            f"path ({cls.name}.{w.method}) and from "
                            f"{cls.name}.{ow.method} (line {ow.line}) with "
                            f"no lock on either side: an unsynchronized "
                            f"cross-thread read-modify-write"))
    return findings


def _retire_capable(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if _self_attr(t) == "retired":
                    return True
    return False


def _is_boundary_call(node: ast.Call) -> bool:
    name = astutil.call_name(node)
    if name in _BOUNDARY_CALLS:
        return True
    if isinstance(node.func, ast.Attribute):
        if node.func.attr in _BOUNDARY_ATTRS:
            return True
        if node.func.attr in _BOUNDARY_SELF_ATTRS \
                and _self_attr(node.func) is not None:
            return True
    return False


def _reads_retired(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr == "retired" \
                and isinstance(n.ctx, ast.Load):
            return True
    return False


def check_retired_recheck(path: str, tree: ast.AST, source: str, parents,
                          spans) -> List[Finding]:
    """RETIRED-RECHECK: in a retire-capable class, shared state mutated
    after a dispatch/readback boundary with no ``self.retired`` re-check
    in between — the abandoned-watchdog-thread race (docs/FAULTS.md)."""
    if not astutil.is_driver_module(path):
        return []
    findings: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef) or not _retire_capable(cls):
            continue
        for m in _methods(cls):
            if m.name in ("__init__", "retire", "prewarm"):
                # __init__ precedes sharing; retire() is the far side of
                # the race; prewarm is the watchdog's PREcondition
                # (docs/FAULTS.md) — it runs before any watchdogged
                # dispatch exists (or on a fresh unshared replacement
                # engine during respawn), never on an abandonable thread
                continue
            events: List[Tuple[int, int, str, int]] = []  # (line, rank, kind, aux)
            for node in ast.walk(m):
                if isinstance(node, (ast.If, ast.While)) \
                        and _reads_retired(node.test):
                    # the check covers everything after its own line —
                    # including a `while not self.retired` loop's body
                    events.append((node.lineno, 1, "check", 0))
                elif isinstance(node, ast.Call) and _is_boundary_call(node):
                    events.append((node.lineno, 2, "boundary", 0))
                else:
                    # setting the flag itself is the discipline, not a
                    # hazard
                    attrs = [a for a in _mutated_attrs(node)
                             if a != "retired"]
                    guard_call = (
                        isinstance(node, ast.Expr)
                        and isinstance(node.value, ast.Call)
                        and _self_attr(node.value.func) in _GUARD_SELF_CALLS)
                    if attrs or guard_call:
                        # rank 3: a store whose RHS holds the boundary call
                        # completes AFTER the call returns — same line, the
                        # mutation is on the abandoned side of the window
                        events.append((node.lineno, 3, "mutation",
                                       1 if guard_call else 0))
            events.sort()
            pending: Optional[int] = None
            for line, _rank, kind, aux in events:
                if kind == "check":
                    pending = None
                elif kind == "boundary":
                    pending = line
                elif pending is not None:
                    what = ("the shared compile guard" if aux
                            else "shared scheduling state")
                    findings.append(Finding(
                        path, line, "RETIRED-RECHECK", Severity.ERROR,
                        f"{cls.name}.{m.name} mutates {what} after the "
                        f"dispatch/readback boundary at line {pending} "
                        f"without re-checking `self.retired`: a watchdog "
                        f"expiry abandons this thread mid-call, retire() "
                        f"hands the state to survivors, and this write "
                        f"races them (the abandoned-watchdog bug class)"))
                    pending = line  # one finding per mutation, keep arming
    return findings


def _has_timeout(call: ast.Call) -> bool:
    return bool(call.args) or bool(call.keywords)


def _in_clock_class(node: ast.AST, parents) -> bool:
    for a in astutil.ancestors(node, parents):
        if isinstance(a, ast.ClassDef) and a.name.endswith("Clock"):
            return True
    return False


def _in_lifecycle_func(node: ast.AST, parents) -> bool:
    fn = astutil.enclosing_function(node, parents)
    return getattr(fn, "name", None) in _LIFECYCLE_FUNCS


def check_sched_block(path: str, tree: ast.AST, source: str, parents,
                      spans) -> List[Finding]:
    """SCHED-BLOCK: uncancellable blocking primitives on driver hot
    paths (outside the *Clock helpers and lifecycle shutdown funcs)."""
    if not astutil.is_driver_module(path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        region = astutil.hot_region_at(spans, node.lineno)
        if region is None:
            continue
        if _in_clock_class(node, parents) or _in_lifecycle_func(node, parents):
            continue
        name = astutil.call_name(node)
        what = None
        if name in _BLOCKING_CALLS:
            what = f"{_BLOCKING_CALLS[name]}(...)"
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _BLOCKING_ATTRS
              and not _has_timeout(node)):
            what = f".{node.func.attr}() with no timeout"
        if what:
            findings.append(Finding(
                path, node.lineno, "SCHED-BLOCK", Severity.ERROR,
                f"{what} inside hot region [{region.desc}]: the scheduler/"
                f"worker hot path blocks uncancellably — route it through "
                f"the clock/backoff helpers, give it a timeout, or waive "
                f"the boundary with a reason"))
    return findings


def check_wall_clock(path: str, tree: ast.AST, source: str, parents,
                     spans) -> List[Finding]:
    """WALL-CLOCK: raw wall-clock reads in modules that schedule under
    serve.server.make_clock, outside the *Clock classes."""
    if astutil.module_key(path) not in _VIRTUAL_CLOCK_FILES:
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node)
        if name not in _WALL_CALLS:
            continue
        if _in_clock_class(node, parents):
            continue
        findings.append(Finding(
            path, node.lineno, "WALL-CLOCK", Severity.ERROR,
            f"{name}() in a module that schedules under make_clock: wall "
            f"time outside the *Clock classes leaks real time into "
            f"virtual-clock replay (or divides wall by virtual) — read "
            f"the loop's clock, or waive the metering boundary with a "
            f"reason"))
    return findings


def _unordered_iter(it: ast.AST) -> Optional[str]:
    """A description of why the iterable's order is settle/schedule
    -dependent, or None. ``sorted(...)`` wrappers are the fix and never
    match (the call name is then 'sorted')."""
    if isinstance(it, ast.Call):
        if isinstance(it.func, ast.Attribute) \
                and it.func.attr in ("values", "items", "keys"):
            return f".{it.func.attr}() of a settle-ordered mapping"
        name = astutil.call_name(it)
        if name in ("set", "frozenset"):
            return "a set (iteration order is unspecified)"
    if isinstance(it, ast.Set):
        return "a set literal"
    return None


def check_float_order(path: str, tree: ast.AST, source: str, parents,
                      spans) -> List[Finding]:
    """FLOAT-ORDER: float accumulation over settle-ordered iteration in
    threaded driver modules (the BLEU-sum bug class)."""
    if not astutil.is_driver_module(path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.For):
            continue
        why = _unordered_iter(node.iter)
        if why is None:
            continue
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.AugAssign)
                    and isinstance(sub.op, ast.Add)):
                continue
            v = sub.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                continue  # integer counting is order-safe
            findings.append(Finding(
                path, sub.lineno, "FLOAT-ORDER", Severity.ERROR,
                f"float `+=` accumulation iterating {why} (loop at line "
                f"{node.lineno}): float addition does not reassociate, so "
                f"the aggregate depends on settle/thread order in the "
                f"last ulp — accumulate per key and sum in sorted order "
                f"(the BLEU-sum fix)"))
    return findings


def check(path: str, tree: ast.AST, source: str, parents, spans,
          ) -> List[Finding]:
    findings: List[Finding] = []
    findings += check_shared_mut(path, tree, source, parents, spans)
    findings += check_retired_recheck(path, tree, source, parents, spans)
    findings += check_sched_block(path, tree, source, parents, spans)
    findings += check_wall_clock(path, tree, source, parents, spans)
    findings += check_float_order(path, tree, source, parents, spans)
    return findings
