"""Shared AST plumbing (counterpart of ``fira_tpu/analysis/astutil.py``):
dotted-name resolution, parent/ancestor walks, the package-relative path
every path-scoped rule keys on, and hot-loop-region designation.

Hot regions are where a host sync is a throughput bug rather than a
boundary. Eager torch has no traced bodies, so JAX's first two
designations (scan/while_loop bodies and jit-wrapped functions) become
the port's step programs; the rest is as in JAX:

1. the step programs of a driver module, listed by name in
   :data:`_STEP_PROGRAMS`: the functions the drivers dispatch under a
   sanitizer ``program_label`` (the train steps, the beam search, the
   slot engine's prefill/insert/step/verify) and the bodies they run
   per position — what a CUDA graph or a compiled program would capture;
2. designated driver files (:data:`_DRIVER_FILES`): every ``for``/
   ``while`` loop body (the step-dispatch loops whose cadence IS the
   throughput story) and every function nested inside a function (the
   step closures those drivers build);
3. closure: a same-module function called by name, or a method of the
   same class called through ``self``, from a hot region is hot too
   (catches helpers like train/loop.py ``sync_tick`` that encapsulate the
   sync, and the slot engine's per-round methods its run loop reaches —
   JAX's closure follows bare names only, where the port's drivers are
   classes).

Every path-scoped rule matches on the path after the LAST
``fira_tpu_torch`` segment (:func:`package_relative`), never on a suffix
shared with the JAX package's paths.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Set

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

PACKAGE = "fira_tpu_torch"

# The designated dispatch drivers, as paths inside the package (the same
# 21 modules as the JAX package's list, each the port's counterpart):
# the train loop, the train-step factories, the decode drivers, the async
# input pipeline (its dispatcher/worker/consumer loops run concurrently
# with every step dispatch — a sync there stalls the feed exactly like
# one in the train loop), the bucket packer and the grouped scheduler
# (their loops run as feeder tasks on the same worker threads), the
# engine's paging/prefix-cache/spec/quant pieces, the fleet, the serving
# loops, the ingest pipeline and the fault/watchdog/recovery machinery.
# NOT every train/decode module — e.g. decode/text.py is host-only text
# cooking and train/state.py is checkpoint I/O. Each entry must be named
# in the self-scan test, tests/test_torch_analysis.py (DRIVER-REG).
_DRIVER_FILES = (
    "train/loop.py", "train/step.py",
    "decode/runner.py", "decode/beam.py",
    "decode/engine.py", "decode/paging.py",
    "decode/prefix_cache.py", "decode/spec.py",
    "decode/quant.py",
    "data/feeder.py", "data/buckets.py",
    "data/grouping.py",
    "parallel/fleet.py",
    "serve/server.py",
    "serve/disagg.py",
    "ingest/difftext.py",
    "ingest/service.py",
    "ingest/cache.py",
    "robust/faults.py",
    "robust/watchdog.py",
    "robust/recovery.py",
)

# The step programs of each driver module, by qualified name ("func" or
# "Class.method"): the torch counterparts of the JAX package's jitted
# functions and scan bodies.
_STEP_PROGRAMS = {
    "train/step.py": ("train_step", "multi_step", "accum_step", "dev_step"),
    "train/loop.py": ("_dispatch",),
    "decode/beam.py": ("beam_search", "beam_search_cached", "_run_steps"),
    "decode/engine.py": ("SlotEngine._prefill", "SlotEngine._insert",
                         "SlotEngine._one_step", "SlotEngine._step",
                         "SlotEngine._spec_round"),
    "decode/spec.py": ("run_verify",),
}


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def last_segment(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def ancestors(node: ast.AST, parents: Dict[ast.AST, ast.AST]
              ) -> Iterator[ast.AST]:
    while node in parents:
        node = parents[node]
        yield node


def enclosing_function(node: ast.AST, parents: Dict[ast.AST, ast.AST]
                       ) -> Optional[ast.AST]:
    for a in ancestors(node, parents):
        if isinstance(a, FunctionNode):
            return a
    return None


def normalize_path(path: str) -> str:
    """Absolute, forward-slash form for rule SCOPING (display paths stay
    as given). Without this, a checkout-relative invocation from inside
    the package ('check train/loop.py' with cwd fira_tpu_torch/) would
    silently disarm the path-scoped rules and report a clean scan."""
    return os.path.abspath(path).replace("\\", "/")


def package_relative(norm: str) -> Optional[str]:
    """Path after the LAST ``fira_tpu_torch`` segment, or None.
    Segment-based so a checkout directory of that name does not arm the
    rules for its tests/ and scripts/ trees, and so no path of the JAX
    package (``fira_tpu/...``) ever matches."""
    segs = norm.split("/")
    for i in range(len(segs) - 1, -1, -1):
        if segs[i] == PACKAGE:
            return "/".join(segs[i + 1:])
    return None


def module_key(path: str) -> Optional[str]:
    """The package-relative path of a scanned file, or None."""
    return package_relative(normalize_path(path))


def is_driver_module(path: str) -> bool:
    return module_key(path) in _DRIVER_FILES


@dataclasses.dataclass(frozen=True)
class HotSpan:
    start: int
    end: int
    desc: str

    def covers(self, line: int) -> bool:
        return self.start <= line <= self.end


def _body_span(node: ast.AST, desc: str) -> Optional[HotSpan]:
    end = getattr(node, "end_lineno", None)
    if end is None:
        return None
    return HotSpan(node.lineno, end, desc)


def qualified_defs(tree: ast.AST) -> Dict[str, ast.AST]:
    """'func' / 'Class.method' -> def node, for module-level functions
    and the methods of module-level classes."""
    out: Dict[str, ast.AST] = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def hot_spans(tree: ast.AST, path: str,
              parents: Dict[ast.AST, ast.AST]) -> List[HotSpan]:
    spans: List[HotSpan] = []
    func_defs: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # last definition wins; good enough for flat modules
            func_defs[node.name] = node

    def add_function(node: ast.AST, desc: str) -> None:
        span = _body_span(node, desc)
        if span:
            spans.append(span)

    key = module_key(path)
    if key in _STEP_PROGRAMS:
        defs = qualified_defs(tree)
        for qual in _STEP_PROGRAMS[key]:
            if qual in defs:
                add_function(defs[qual], f"step program `{qual}`")

    if key in _DRIVER_FILES:
        for node in ast.walk(tree):
            if isinstance(node, (ast.For, ast.While)):
                span = _body_span(node, f"driver loop (line {node.lineno})")
                if span:
                    spans.append(span)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if isinstance(enclosing_function(node, parents), FunctionNode):
                    add_function(node, f"driver step closure `{node.name}`")

    # Closure: same-module functions and same-class methods called from
    # hot regions become hot.
    def covered(line: int) -> Optional[HotSpan]:
        for s in spans:
            if s.covers(line):
                return s
        return None

    methods = {q: n for q, n in qualified_defs(tree).items() if "." in q}
    calls = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = call_name(node)
        if fname in func_defs:
            calls.append((node, fname, func_defs[fname]))
        elif fname and fname.startswith("self.") and fname.count(".") == 1:
            cls = next((a for a in ancestors(node, parents)
                        if isinstance(a, ast.ClassDef)), None)
            qual = f"{cls.name}.{fname[5:]}" if cls is not None else None
            if qual in methods:
                calls.append((node, qual, methods[qual]))
    changed = True
    hot_names: Set[str] = set()
    while changed:
        changed = False
        for node, name, fn in calls:
            if name not in hot_names and covered(node.lineno):
                hot_names.add(name)
                add_function(fn, f"`{name}` (called from hot region, line "
                                 f"{node.lineno})")
                changed = True
    return spans


def hot_region_at(spans: List[HotSpan], line: int) -> Optional[HotSpan]:
    best: Optional[HotSpan] = None
    for s in spans:
        if s.covers(line) and (best is None or s.start >= best.start):
            best = s  # innermost (latest-starting) region names the message
    return best
