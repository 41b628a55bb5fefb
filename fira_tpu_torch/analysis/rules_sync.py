"""HOST-SYNC: host/device synchronization inside hot-loop regions
(counterpart of ``fira_tpu/analysis/rules_sync.py``, with torch's
primitives).

The port's throughput story rests on the driver never waiting for the
card except at logging/dev/output boundaries: one stray ``.item()`` per
step serializes the launch queue with the kernels it feeds, and a step
body with a host read cannot be captured into a CUDA graph. This rule
flags every sync primitive inside a designated hot region (see
astutil.hot_spans); the honest boundaries carry
``# firacheck: allow[HOST-SYNC] <reason>``.

Flagged primitives:
- ``x.item()``, ``x.cpu()``, ``x.numpy()``, ``x.tolist()`` (one finding
  per chain: ``x.cpu().numpy()`` is reported at its ``.cpu()``);
- ``x.to("cpu")`` / ``x.to(device="cpu")``;
- ``torch.cuda.synchronize()`` and ``<event or stream>.synchronize()``;
- ``np.asarray(x)`` / ``np.array(x)``;
- ``float(x)`` / ``int(x)`` / ``bool(x)`` where x is a bare
  variable/attribute/subscript — the classic regressed ``float(loss)``.
  Conversions of call results are not double-flagged: the inner call is
  either itself a sync primitive (flagged once) or host-side already;
- an ``.any()`` / ``.all()`` / ``torch.equal(...)`` result used as a
  Python truth value — in an ``if``/``while`` test, a conditional
  expression or ``bool(...)``: the branch needs the value on the host.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from fira_tpu_torch.analysis import astutil
from fira_tpu_torch.analysis.findings import Finding, Severity

_SYNC_ATTRS = {"item", "cpu", "numpy", "tolist", "synchronize"}
_SYNC_CALLS = {"torch.cuda.synchronize", "np.asarray", "np.array",
               "numpy.asarray", "numpy.array"}
_CASTS = {"float", "int", "bool"}
_TRUTH_ATTRS = {"any", "all"}
_TRUTH_CALLS = {"torch.equal"}


def _cast_arg_is_value_expr(call: ast.Call) -> bool:
    if len(call.args) != 1 or call.keywords:
        return False
    arg = call.args[0]
    if not isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript)):
        return False
    # an argument containing a call is not double-flagged: the inner call
    # is either itself a sync primitive (reported once) or host-side
    return not any(isinstance(n, ast.Call) for n in ast.walk(arg))


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _to_cpu(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    if call.args and _is_cpu(call.args[0]):
        return True
    return any(kw.arg == "device" and _is_cpu(kw.value)
               for kw in call.keywords)


def _sync_what(call: ast.Call) -> Optional[str]:
    """What sync primitive ``call`` is, or None."""
    name = astutil.call_name(call)
    if name in _SYNC_CALLS:
        return f"{name}(...)"
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _SYNC_ATTRS and not call.args:
        return f".{call.func.attr}()"
    if _to_cpu(call):
        return ".to('cpu')"
    return None


def _receiver_syncs(call: ast.Call) -> bool:
    """Does ``call``'s receiver chain already hold a sync primitive
    (``x.cpu().numpy()``: the ``.numpy()`` copies nothing more)?"""
    probe = call.func.value if isinstance(call.func, ast.Attribute) \
        else None
    while probe is not None:
        if isinstance(probe, ast.Call):
            if _sync_what(probe) and isinstance(probe.func, ast.Attribute):
                return True
            probe = probe.func
        elif isinstance(probe, (ast.Attribute, ast.Subscript)):
            probe = probe.value
        else:
            return False
    return False


def _truth_results(expr: ast.AST) -> List[Tuple[ast.Call, str]]:
    """The ``.any()``/``.all()``/``torch.equal`` calls whose results
    ``expr`` (a truth-tested expression) evaluates."""
    out: List[Tuple[ast.Call, str]] = []
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TRUTH_ATTRS:
            out.append((node, f".{node.func.attr}()"))
        elif astutil.call_name(node) in _TRUTH_CALLS:
            out.append((node, "torch.equal(...)"))
    return out


def _truth_tests(tree: ast.AST) -> List[ast.AST]:
    """Every expression Python reads as a truth value: if/while/ternary
    tests and the argument of ``bool(...)``."""
    out: List[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            out.append(node.test)
        elif isinstance(node, ast.Call) \
                and astutil.call_name(node) == "bool" \
                and len(node.args) == 1:
            out.append(node.args[0])
    return out


def _finding(path: str, line: int, what: str, region) -> Finding:
    return Finding(
        path, line, "HOST-SYNC", Severity.ERROR,
        f"{what} inside hot region [{region.desc}]: forces a host/device "
        f"sync in the hot loop; move it to a logging/dev boundary or "
        f"waive with a reason")


def check(path: str, tree: ast.AST, source: str, parents, spans,
          ) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        region = astutil.hot_region_at(spans, node.lineno)
        if region is None:
            continue
        name = astutil.call_name(node)
        what = _sync_what(node)
        if what and isinstance(node.func, ast.Attribute) \
                and name not in _SYNC_CALLS and _receiver_syncs(node):
            what = None
        if what is None and name in _CASTS \
                and _cast_arg_is_value_expr(node):
            src = ast.unparse(node.args[0])
            what = f"{name}({src}) on a (possible) device value"
        if what:
            findings.append(_finding(path, node.lineno, what, region))
    seen: Set[int] = set()   # a call under `if bool(...)` is one read
    for test in _truth_tests(tree):
        for call, what in _truth_results(test):
            region = astutil.hot_region_at(spans, call.lineno)
            if region is None or id(call) in seen:
                continue
            seen.add(id(call))
            findings.append(_finding(
                path, call.lineno, f"{what} result used as a truth value",
                region))
    return findings
