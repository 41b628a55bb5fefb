"""Serving-contract lints (counterpart of
``fira_tpu/analysis/rules_contracts.py``): the repo's own merge
contracts, mechanized (docs/ANALYSIS.md "v2: contract lints";
docs/ANALYSIS_TORCH.md for the port's forms).

Three registry passes over conventions every PR since 8 has maintained by
hand — each encodes a promise some other file silently depends on:

- KNOB-VALIDATE — every config knob a CLI flag writes is admitted at
  parse time: either a validator somewhere reads ``cfg.<knob>`` (a
  ``*_errors`` function, or config.py's ``unsupported``, the port's
  counterpart of the JAX package's ``config_errors``), or the flag
  itself constrains its value (``choices``, a validating ``type``
  callable, ``store_true``). The repo's exit-2 contract: a bad knob is
  a named parse-time rejection, never a mid-run traceback. The flag->config funnel is the JAX CLI's ``_resolve_cfg``
  (``overrides["knob"] = args.x``) or the port CLI's ``resolve_config``
  (``cfg.replace(knob=args.x)`` and its knob-table loops).
- FAULT-SITE — every site string handed to the fault injector
  (``.check("x.y")`` / ``.corrupt("x.y", ...)`` / ``.armed("x.y")``) is
  registered in ``robust.faults.SITES``, and corrupt-capable sites are
  in ``CORRUPT_SITES``: an unregistered site arms NOTHING (the spec
  parser rejects it), so a typo'd site silently un-tests its
  degradation contract.
- DRIVER-REG — every module that dispatches step programs (a
  ``program_label(...)`` dispatch, the port's counterpart of a jitted
  program, or a CUDA graph / ``torch.compile`` built in it) or drives
  the engine/fleet steppables (``SlotEngine`` / ``EngineFleet``) is a
  designated driver module (``analysis.astutil._DRIVER_FILES``) AND
  named in the port's self-scan test, ``tests/test_torch_analysis.py``
  (the JAX package's ``scripts/check.sh`` names the JAX package's
  drivers): otherwise its dispatch loops are invisible to the
  hot-region rules and a refactor of the scan can drop it.
- STATS-SCHEMA (v3) — the observability contract for ``*Stats``
  classes that own a ``summary()``: (a) every declared field is READ by
  ``summary()`` or a helper/property it reaches (a field the snapshot
  never serializes is invisible drift — the ``workers`` /
  ``pipeline_depth`` class of bug, once closed by hand); (b) every
  ``self.X`` the summary closure reads is a declared field / method /
  assigned attribute of the class (the typo'd-key direction); (c) for
  the repo's real stats classes (:data:`_STATS_DOC_CLASSES`), every
  field is named somewhere under ``docs/`` — a serialized key nobody
  documented is a key consumers cannot rely on (WARNING).

The cross-file state lives in :class:`ContractRegistry`, merged by the
engine's pass 1. When the
scan does not include ``robust/faults.py`` (a partial scan), the site
registry falls back to importing the real module, so subset scans never
false-positive on registered sites.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from fira_tpu_torch.analysis import astutil
from fira_tpu_torch.analysis.findings import Finding, Severity
from fira_tpu_torch.analysis.rules_trace import program_construction

# argparse `type=` callables that validate nothing beyond shape
_PLAIN_TYPES = {"int", "float", "str"}
_INJECTOR_HINTS = ("fault", "injector")
_STEPPABLE_NAMES = {"SlotEngine", "EngineFleet"}
# the real observability classes whose fields must also be docs-named;
# fixture *Stats classes get checks (a)/(b) but not the docs half
_STATS_DOC_CLASSES = ("EngineStats", "FleetStats", "ServeStats")
# validator functions besides the *_errors ones: config.py's refusal list
_VALIDATORS = ("unsupported",)
# the flag->config funnels: the JAX CLI's and the port CLI's
_FUNNELS = ("_resolve_cfg", "resolve_config")
# the call that dispatches a labelled step program (analysis/sanitizer.py)
_PROGRAM_DISPATCH = "program_label"
# the self-scan that must name every registered driver module
_SELF_SCAN_TEST = os.path.join("tests", "test_torch_analysis.py")


@dataclasses.dataclass
class ContractRegistry:
    """Cross-file contract state, merged over every scanned file."""

    # cfg fields read by some `*_errors` validator function
    validated_fields: Set[str] = dataclasses.field(default_factory=set)
    # fault-site registry (robust/faults.py SITES / CORRUPT_SITES)
    sites: Set[str] = dataclasses.field(default_factory=set)
    corrupt_sites: Set[str] = dataclasses.field(default_factory=set)
    sites_seen: bool = False  # a faults.py module was in the scan


def _module_tuple(tree: ast.AST, name: str) -> List[Tuple[int, str]]:
    """(line, value) per string element of a module-level ``name = (...)``
    tuple assignment."""
    out: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in node.targets):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            for e in node.value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out.append((e.lineno, e.value))
    return out


def _getattr_name(node: ast.AST, owner: str) -> Optional[ast.AST]:
    """The name argument of a ``getattr(<owner>, name)`` call, or None."""
    if isinstance(node, ast.Call) and astutil.call_name(node) == "getattr" \
            and len(node.args) >= 2 and isinstance(node.args[0], ast.Name) \
            and node.args[0].id == owner:
        return node.args[1]
    return None


def _str_constants(node: ast.AST) -> List[str]:
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def _loop_table(loop: ast.For, owner: str) -> List[str]:
    """The knob names of a knob-table loop ``for knob, ... in (("X",
    ...), ...)`` whose body reads ``getattr(<owner>, knob)``, else []."""
    names = {n.id for n in ast.walk(loop.target) if isinstance(n, ast.Name)}
    for n in ast.walk(loop):
        arg = _getattr_name(n, owner)
        if isinstance(arg, ast.Name) and arg.id in names:
            return _str_constants(loop.iter)
    return []


def _validated_fields(fn: ast.AST) -> Set[str]:
    """cfg fields a validator reads: ``cfg.X``, ``getattr(cfg, "X")``
    and the knob-table loops over ``getattr(cfg, knob)``."""
    out: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Attribute) \
                and isinstance(sub.value, ast.Name) \
                and sub.value.id == "cfg":
            out.add(sub.attr)
        elif isinstance(sub, ast.For):
            out.update(_loop_table(sub, "cfg"))
        else:
            arg = _getattr_name(sub, "cfg")
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.add(arg.value)
    return out


def collect(path: str, tree: ast.AST, registry: ContractRegistry) -> None:
    """Pass-1 hook: fold one file's contract state into the registry."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and (node.name.endswith("_errors")
                     or node.name in _VALIDATORS):
            registry.validated_fields |= _validated_fields(node)
    if os.path.basename(path) == "faults.py":
        sites = _module_tuple(tree, "SITES")
        corrupt = _module_tuple(tree, "CORRUPT_SITES")
        if sites:
            registry.sites_seen = True
            registry.sites.update(v for _ln, v in sites)
            registry.corrupt_sites.update(v for _ln, v in corrupt)


def finalize(registry: ContractRegistry) -> None:
    """After pass 1: a scan that did not include robust/faults.py reads
    the port's REAL site registry instead of flagging every site as
    unknown."""
    if not registry.sites_seen:
        try:
            from fira_tpu_torch.robust import faults as faults_lib

            registry.sites.update(faults_lib.SITES)
            registry.corrupt_sites.update(faults_lib.CORRUPT_SITES)
            registry.sites_seen = True
        except Exception:
            pass  # no package available: FAULT-SITE stays disarmed


# --------------------------------------------------------------------------
# KNOB-VALIDATE
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _FlagInfo:
    choices: bool = False
    store_true: bool = False
    custom_type: bool = False

    @property
    def self_validating(self) -> bool:
        return self.choices or self.store_true or self.custom_type


def _argparse_flags(tree: ast.AST) -> Dict[str, _FlagInfo]:
    """dest -> constraint info for every ``add_argument`` call in the
    file (dest derived from the first ``--option-string`` or positional
    name, or an explicit ``dest=``)."""
    flags: Dict[str, _FlagInfo] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument" and node.args):
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            continue
        dest = first.value.lstrip("-").replace("-", "_")
        info = _FlagInfo()
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = str(kw.value.value)
            elif kw.arg == "choices":
                info.choices = True
            elif kw.arg == "action" \
                    and isinstance(kw.value, ast.Constant) \
                    and kw.value.value in ("store_true", "store_false"):
                info.store_true = True
            elif kw.arg == "type":
                tname = astutil.dotted(kw.value)
                if tname is None or astutil.last_segment(tname) \
                        not in _PLAIN_TYPES:
                    info.custom_type = True
        flags[dest] = info
    return flags


def _args_attrs(node: ast.AST) -> List[str]:
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                and n.value.id == "args":
            out.append(n.attr)
    return out


def _knob_writes(resolve: ast.AST) -> List[Tuple[ast.AST, str,
                                                 Optional[ast.AST],
                                                 List[str]]]:
    """(node, knob, value expr, flag dests) for every config write in a
    funnel: ``overrides["knob"] = value``, ``cfg.replace(knob=value)``,
    and the port's two knob-table loops — ``for given, knob, value in
    ((args.x, "knob", v), ...)`` (each row names its flag) and ``for knob
    in ("knob", ...)`` over ``getattr(args, knob)`` (the knob IS the
    flag's dest)."""
    out: List[Tuple[ast.AST, str, Optional[ast.AST], List[str]]] = []
    for node in ast.walk(resolve):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                    and t.value.id == "overrides" \
                    and isinstance(t.slice, ast.Constant) \
                    and isinstance(t.slice.value, str):
                out.append((node, t.slice.value, node.value, []))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "replace":
            for kw in node.keywords:
                if kw.arg is not None:
                    out.append((node, kw.arg, kw.value, []))
        elif isinstance(node, ast.For) \
                and isinstance(node.iter, (ast.Tuple, ast.List)):
            if _loop_table(node, "args"):
                for e in node.iter.elts:
                    for knob in _str_constants(e):
                        out.append((e, knob, None, [knob]))
            elif isinstance(node.target, ast.Tuple):
                for e in node.iter.elts:
                    knobs = _str_constants(e)
                    if knobs:
                        out.append((e, knobs[0], None, _args_attrs(e)))
    return out


def check_knob_validate(path: str, tree: ast.AST, parents,
                        registry: ContractRegistry) -> List[Finding]:
    """KNOB-VALIDATE: runs in files that define a flag->config funnel
    (``_resolve_cfg`` or ``resolve_config``). Disarmed when the scan saw
    NO validator functions at all (a partial scan has nothing to compare
    against)."""
    if not registry.validated_fields:
        return []
    resolve = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in _FUNNELS:
            resolve = node
            break
    if resolve is None:
        return []
    flags = _argparse_flags(tree)
    findings: List[Finding] = []
    for node, field, value, attrs in _knob_writes(resolve):
        if field in registry.validated_fields:
            continue
        # which CLI flag feeds this knob: the RHS's args.<attr>, else the
        # nearest enclosing condition's (a `store_true`-gated literal)
        if not attrs and value is not None:
            attrs = _args_attrs(value)
        if not attrs:
            for a in astutil.ancestors(node, parents):
                if a is resolve:
                    break
                if isinstance(a, ast.If):
                    attrs = _args_attrs(a.test)
                    if attrs:
                        break
        covered = any(flags.get(a, _FlagInfo()).self_validating
                      for a in attrs)
        if not covered:
            via = (f"--{attrs[0].replace('_', '-')}" if attrs
                   else "a computed value")
            findings.append(Finding(
                path, node.lineno, "KNOB-VALIDATE", Severity.ERROR,
                f"config knob '{field}' is set from the CLI ({via}) but "
                f"no *_errors validator reads cfg.{field} and the flag "
                f"carries no choices/validating type: a bad value becomes "
                f"a mid-run traceback instead of a named exit-2 rejection"))
    return findings


# --------------------------------------------------------------------------
# FAULT-SITE
# --------------------------------------------------------------------------

def _injector_receiver(func: ast.AST) -> bool:
    if not isinstance(func, ast.Attribute):
        return False
    recv = astutil.dotted(func.value)
    if not recv:
        return False
    seg = astutil.last_segment(recv).lower()
    return any(h in seg for h in _INJECTOR_HINTS)


def check_fault_site(path: str, tree: ast.AST,
                     registry: ContractRegistry) -> List[Finding]:
    """FAULT-SITE: every dotted site string handed to an injector-shaped
    receiver's check/corrupt/armed is registered; corrupt requires
    CORRUPT_SITES membership. Disarmed without a site registry."""
    if not registry.sites_seen:
        return []
    if os.path.basename(path) == "faults.py":
        return []  # the registry definition site itself
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("check", "corrupt", "armed")
                and _injector_receiver(node.func) and node.args):
            continue
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                and "." in arg.value):
            continue
        site = arg.value
        if site not in registry.sites:
            findings.append(Finding(
                path, node.lineno, "FAULT-SITE", Severity.ERROR,
                f"fault site '{site}' is not registered in "
                f"robust.faults.SITES: the spec parser rejects it, so no "
                f"chaos run can ever arm this injection point — register "
                f"it or fix the typo"))
        elif node.func.attr == "corrupt" \
                and site not in registry.corrupt_sites:
            findings.append(Finding(
                path, node.lineno, "FAULT-SITE", Severity.ERROR,
                f"fault site '{site}' is used with corrupt() but is not "
                f"in robust.faults.CORRUPT_SITES: only sites owning a "
                f"host payload may scramble one (docs/FAULTS.md) — "
                f"register it corrupt-capable or drop the call"))
    return findings


# --------------------------------------------------------------------------
# DRIVER-REG
# --------------------------------------------------------------------------

def _steppable_use(tree: ast.AST) -> Optional[int]:
    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if any(a.name in _STEPPABLE_NAMES for a in node.names):
                lines.append(node.lineno)
        elif isinstance(node, ast.Attribute) \
                and node.attr in _STEPPABLE_NAMES:
            lines.append(node.lineno)
    return min(lines) if lines else None


def _program_use(tree: ast.AST) -> Optional[int]:
    """First line that dispatches a labelled step program or builds a
    CUDA graph / compiled program, else None."""
    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and (
                astutil.last_segment(astutil.call_name(node))
                == _PROGRAM_DISPATCH or program_construction(node)):
            lines.append(node.lineno)
    return min(lines) if lines else None


def _find_self_scan_test(path: str) -> Optional[str]:
    """tests/test_torch_analysis.py located by walking up from the
    scanned file."""
    d = os.path.dirname(astutil.normalize_path(path))
    for _ in range(6):
        cand = os.path.join(d, _SELF_SCAN_TEST)
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None


def check_driver_reg(path: str, tree: ast.AST) -> List[Finding]:
    """DRIVER-REG, per-module half: a fira_tpu_torch module that
    dispatches step programs or drives engine/fleet steppables must be a
    designated driver module."""
    rel = astutil.module_key(path)
    if rel is None or not rel or rel.startswith("analysis/") \
            or os.path.basename(path) == "__init__.py":
        return []
    if astutil.is_driver_module(path):
        return []
    findings: List[Finding] = []
    line = _steppable_use(tree)
    if line is not None:
        findings.append(Finding(
            path, line, "DRIVER-REG", Severity.ERROR,
            f"module drives the engine/fleet steppables but is not in "
            f"analysis.astutil._DRIVER_FILES: its scheduling loops are "
            f"invisible to the hot-region/concurrency rules — register "
            f"it (and name it in {_SELF_SCAN_TEST}) or waive with a "
            f"reason"))
        return findings
    line = _program_use(tree)
    if line is not None:
        findings.append(Finding(
            path, line, "DRIVER-REG", Severity.ERROR,
            f"module dispatches step programs (program_label, CUDA graph, "
            f"torch.compile) but is not in analysis.astutil._DRIVER_FILES: "
            f"its dispatch loops are invisible to the hot-region/"
            f"concurrency rules — register it (and name it in "
            f"{_SELF_SCAN_TEST}) or waive with a reason"))
    return findings


def check_driver_names(path: str, tree: ast.AST) -> List[Finding]:
    """DRIVER-REG, registry half: runs only on the file that defines
    _DRIVER_FILES (analysis/astutil.py) — every registered driver module
    must be NAMED (as ``fira_tpu_torch/<entry>``) in the self-scan test,
    so a refactor of that scan can never silently drop one from the
    gate."""
    entries = _module_tuple(tree, "_DRIVER_FILES")
    if not entries:
        return []
    sh = _find_self_scan_test(path)
    if sh is None:
        return []  # no self-scan test in this checkout: nothing to pin
    try:
        with open(sh, encoding="utf-8", errors="replace") as f:
            text = f.read()
    except OSError:
        return []
    findings: List[Finding] = []
    for line, entry in entries:
        if f"{astutil.PACKAGE}/{entry}" not in text:
            findings.append(Finding(
                path, line, "DRIVER-REG", Severity.ERROR,
                f"driver module '{entry}' (_DRIVER_FILES) is not named in "
                f"{_SELF_SCAN_TEST}: the self-scan would silently lose it "
                f"if the directory arguments ever change — name it in the "
                f"self-scan's invocation"))
    return findings


# --------------------------------------------------------------------------
# STATS-SCHEMA (v3)
# --------------------------------------------------------------------------

def _stats_members(cls: ast.ClassDef) -> Tuple[Dict[str, int], Set[str],
                                               Set[str], Set[str]]:
    """(fields -> line, method names, property names, self-assigned
    attrs) for one class body."""
    fields: Dict[str, int] = {}
    methods: Set[str] = set()
    props: Set[str] = set()
    assigned: Set[str] = set()
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            ann = astutil.dotted(node.annotation) or ""
            if astutil.last_segment(ann) != "ClassVar":
                fields[node.target.id] = node.lineno
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods.add(node.name)
            if any(astutil.dotted(d) in ("property", "functools.cached_property",
                                         "cached_property")
                   for d in node.decorator_list):
                props.add(node.name)
    for node in ast.walk(cls):
        if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Store) \
                and isinstance(node.value, ast.Name) and node.value.id == "self":
            assigned.add(node.attr)
    return fields, methods, props, assigned


def _summary_closure(cls: ast.ClassDef, methods: Set[str],
                     props: Set[str]) -> Set[str]:
    """Methods/properties transitively reachable from summary(): follow
    ``self.m(...)`` calls and ``self.p`` property reads."""
    bodies = {n.name: n for n in cls.body
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    closure: Set[str] = set()
    frontier = ["summary"]
    while frontier:
        name = frontier.pop()
        if name in closure or name not in bodies:
            continue
        closure.add(name)
        for node in ast.walk(bodies[name]):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                if node.attr in methods and (
                        node.attr in props
                        or isinstance(node.ctx, ast.Load)):
                    frontier.append(node.attr)
    return closure


def _docs_text(path: str) -> Optional[str]:
    """Concatenated docs/*.md found by walking up from the scanned file
    (same discovery as _find_self_scan_test); None when this checkout
    carries no docs tree — the docs half of STATS-SCHEMA then stays
    disarmed."""
    d = os.path.dirname(astutil.normalize_path(path))
    for _ in range(6):
        cand = os.path.join(d, "docs")
        if os.path.isdir(cand):
            chunks = []
            try:
                for name in sorted(os.listdir(cand)):
                    if name.endswith(".md"):
                        with open(os.path.join(cand, name),
                                  encoding="utf-8", errors="replace") as f:
                            chunks.append(f.read())
            except OSError:
                return None
            return "\n".join(chunks)
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None


def check_stats_schema(path: str, tree: ast.AST) -> List[Finding]:
    """STATS-SCHEMA: see the module docstring. Purely per-file — a
    stats class and its summary() always live together."""
    import re

    findings: List[Finding] = []
    docs: Optional[str] = None
    docs_loaded = False
    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef)
                and cls.name.endswith("Stats")):
            continue
        fields, methods, props, assigned = _stats_members(cls)
        if "summary" not in methods or not fields:
            continue
        closure = _summary_closure(cls, methods, props)
        reads: Set[str] = set()
        bodies = {n.name: n for n in cls.body
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for name in closure:
            for node in ast.walk(bodies[name]):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, ast.Load) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self":
                    reads.add(node.attr)
        for field, line in sorted(fields.items(), key=lambda kv: kv[1]):
            if field not in reads:
                findings.append(Finding(
                    path, line, "STATS-SCHEMA", Severity.ERROR,
                    f"{cls.name}.{field} is never serialized: summary() "
                    f"and the helpers it reaches never read "
                    f"self.{field}, so the metrics snapshot silently "
                    f"drops the field — serialize it or delete it"))
        declared = set(fields) | methods | assigned
        for name in sorted(closure):
            for node in ast.walk(bodies[name]):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, ast.Load) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and node.attr not in declared:
                    findings.append(Finding(
                        path, node.lineno, "STATS-SCHEMA", Severity.ERROR,
                        f"summary() path reads self.{node.attr} which "
                        f"{cls.name} never declares as a field, method, "
                        f"or assigned attribute — a serialized key with "
                        f"no backing state (the workers/pipeline_depth "
                        f"drift class)"))
                    declared.add(node.attr)  # one finding per name
        if cls.name in _STATS_DOC_CLASSES:
            if not docs_loaded:
                docs = _docs_text(path)
                docs_loaded = True
            if docs is not None:
                for field, line in sorted(fields.items(),
                                          key=lambda kv: kv[1]):
                    if not re.search(rf"\b{re.escape(field)}\b", docs):
                        findings.append(Finding(
                            path, line, "STATS-SCHEMA", Severity.WARNING,
                            f"{cls.name}.{field} is not named anywhere "
                            f"under docs/ — a metrics key consumers "
                            f"cannot rely on; add it to the stats table "
                            f"in docs/ANALYSIS_TORCH.md"))
    return findings


def check(path: str, tree: ast.AST, source: str, parents, spans, *,
          registry: Optional[ContractRegistry] = None) -> List[Finding]:
    registry = registry if registry is not None else ContractRegistry()
    findings: List[Finding] = []
    findings += check_knob_validate(path, tree, parents, registry)
    findings += check_fault_site(path, tree, registry)
    findings += check_driver_reg(path, tree)
    findings += check_driver_names(path, tree)
    findings += check_stats_schema(path, tree)
    return findings
